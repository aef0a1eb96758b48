"""Device ops: the hand-written CUDA kernels (``topk``, ``em``, ``w8a8``,
``attention``, ``distance.estep_assign``), their plain PyTorch versions,
and the plain pieces around them (``distance``, ``segment``, ``kpp``,
and ``wta``, winner-take-all hashing of embeddings)."""
