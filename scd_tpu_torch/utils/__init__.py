"""Host utilities of the port: experiment bootstrap and metric streams,
stage timing and profiling, run-log scraping and figure savers.  Exports
what ``scd_tpu/utils/__init__.py`` exports, less the JAX-only
``enable_compilation_cache`` (see ``utils/runtime.py``)."""
from scd_tpu_torch.utils.runtime import block_timed  # noqa: F401
from scd_tpu_torch.utils.experiment import (  # noqa: F401
    AverageMeter,
    IndicatePlateau,
    MetricWriter,
    init_experiment,
    read_scalars,
)
from scd_tpu_torch.utils.logparse import parse_run_log, summarize_runs  # noqa: F401
