from scd_tpu_torch.core.cache import ArtifactCache, tensors_from_arrays  # noqa: F401
from scd_tpu_torch.core.config import (  # noqa: F401
    ClusterConfig,
    DataConfig,
    FeatureConfig,
    MeshConfig,
    NamingConfig,
    PipelineConfig,
    TrainConfig,
    config_hash,
    flat_override,
)
from scd_tpu_torch.core.device import resolve_device  # noqa: F401
