"""scd_tpu_torch: the PyTorch/CUDA port of scd_tpu.

A second package beside the JAX one (``scd_tpu``), which stays the
reference.  It takes the same config tree, reads and writes the same
artifact caches, and prints the same metric lines.  Its kernels are
written by hand in CUDA C++ for Hopper (``csrc/``), each beside a plain
PyTorch version that the CPU runs.  It imports neither JAX nor anything
of ``scd_tpu``.
"""

from scd_tpu_torch.core.config import (  # noqa: F401
    ClusterConfig,
    DataConfig,
    FeatureConfig,
    MeshConfig,
    NamingConfig,
    PipelineConfig,
    TrainConfig,
    config_hash,
)

__version__ = "0.1.0"
