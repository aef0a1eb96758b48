from scd_tpu_torch.metrics.cluster import (  # noqa: F401
    cluster_acc,
    contingency_matrix,
    evaluate_clustering,
    log_accs_from_preds,
    purity_score,
    split_cluster_acc_v1,
    split_cluster_acc_v2,
    split_cluster_acc_v3,
    topk_accuracy,
)
from scd_tpu_torch.metrics.semantic import (  # noqa: F401
    evaluate_semantic_acc,
    evaluate_soft_semantic_acc,
    name_set_iou,
)
