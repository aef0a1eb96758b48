from scd_tpu_torch.data.core import (  # noqa: F401
    GCDSplits,
    ImageTable,
    MergedDataset,
    build_gcd_splits,
    subsample_instances,
)
from scd_tpu_torch.data.registry import get_class_splits, get_datasets  # noqa: F401
from scd_tpu_torch.data.transforms import (  # noqa: F401
    clip_preprocess,
    get_transform,
)
from scd_tpu_torch.data.loader import iterate_batches  # noqa: F401
from scd_tpu_torch.data.augment import (  # noqa: F401
    ContrastiveViewGenerator,
    RandAugment,
    cutout,
)
