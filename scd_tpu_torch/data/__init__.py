from scd_tpu_torch.data.core import (  # noqa: F401
    GCDSplits,
    ImageTable,
    MergedDataset,
    build_gcd_splits,
    subsample_instances,
)
from scd_tpu_torch.data.registry import get_class_splits, get_datasets  # noqa: F401
