from scd_tpu_torch.cluster.kmeans import (  # noqa: F401
    KMeansResult,
    fit_kmeans,
    fit_kmeans_from_labels,
    fit_sskm,
)
