from scd_tpu_torch.naming.wordnet import Taxonomy  # noqa: F401
from scd_tpu_torch.naming.vote import (  # noqa: F401
    assign_name,
    assign_name_on_leftover,
    cluster_name_counters,
    topk_names,
)
from scd_tpu_torch.naming.loop import (  # noqa: F401
    VotingResult,
    textual_enhancement,
    voting_loop,
    voting_loop_te,
)
