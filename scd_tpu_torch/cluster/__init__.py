from scd_tpu_torch.cluster.constrained import (  # noqa: F401
    fit_constrained,
    fit_constrained_unsup,
)
from scd_tpu_torch.cluster.estimate_k import estimate_k  # noqa: F401
from scd_tpu_torch.cluster.finch import finch, finch_fit  # noqa: F401
from scd_tpu_torch.cluster.kmeans import (  # noqa: F401
    KMeansResult,
    fit_kmeans,
    fit_kmeans_from_labels,
    fit_sskm,
)
