"""The port's counterparts of the JAX package's ``scripts/``: the shell
wrappers (``*.sh``, each ``python -m scd_tpu_torch.…`` with the JAX
wrapper's flags, environment variables and defaults), the scale smoke and
the multi-process smoke."""
