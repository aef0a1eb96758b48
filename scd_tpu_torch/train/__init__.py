"""Training (port of ``scd_tpu/train``): the losses, the schedules, the
checkpoint manager, the GCD trainer and its ``metric_learn`` entry point,
and the NCD baselines (UNO v2, AutoNovel, the supervised classifier +
combine): over frozen features (``baselines``, ``run_baseline``) and end
to end through a ViT (``baselines_e2e``, ``run_baseline_e2e``).
"""

from scd_tpu_torch.train.losses import (  # noqa: F401
    info_nce_loss,
    label_smoothing_ce,
    nt_xent_loss,
    supcon_loss,
)
from scd_tpu_torch.train.gcd import DINOHead, GCDTrainer, make_gcd_state  # noqa: F401
from scd_tpu_torch.train.schedulers import (  # noqa: F401
    cosine_warmup_schedule,
    get_scheduler,
    linear_rampup,
    sigmoid_rampup,
)
from scd_tpu_torch.train.checkpoint import CheckpointManager, strip_key_prefix  # noqa: F401
from scd_tpu_torch.train.baselines_e2e import (  # noqa: F401
    train_autonovel_e2e,
    train_uno_e2e,
)
