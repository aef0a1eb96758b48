"""Experiment bootstrap and observability.

Port of ``scd_tpu/utils/experiment.py`` (reference
``gcd/project_utils/general_utils.py``: ``init_experiment``, :92-152;
``AverageMeter``, ``cluster_utils.py:117``; ``IndicatePlateau``,
``general_utils.py:273-330``).  Scalars stream to an append-only JSONL
file, ``scalars.jsonl``, one line per event, with no TensorBoard mirror
(the port does not depend on the tensorboard package); :func:`read_scalars`
reads them back.  Run directories keep the reference's ``(dd.mm.yyyy_|_id)`` naming,
and :func:`config_hash` is ``core.config.config_hash`` of the config as a
dict, the JAX package's key.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
import uuid
from typing import Dict, Optional

import numpy as np


class MetricWriter:
    """Scalar metric stream to ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "scalars.jsonl")
        self._fh = open(self._path, "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None):
        self._fh.write(json.dumps(
            {"tag": tag, "value": float(value), "step": step,
             "ts": time.time()}) + "\n")

    def add_scalars(self, tag: str, values: Dict[str, float],
                    step: Optional[int] = None):
        for k, v in values.items():
            self.add_scalar(f"{tag}/{k}", v, step)

    def add_hparams(self, hparams: Dict) -> None:
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump({k: v for k, v in hparams.items()
                       if isinstance(v, (int, float, str, bool))}, f,
                      indent=2, sort_keys=True)

    def close(self):
        self._fh.close()


def read_scalars(log_dir: str) -> Dict[str, np.ndarray]:
    """{tag: [[step, value], ...]} from a run's scalars.jsonl (the
    reference scrapes TensorBoard event files, ``general_utils.py:236-267``;
    a step of None reads -1)."""
    out: Dict[str, list] = {}
    path = os.path.join(log_dir, "scalars.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            out.setdefault(ev["tag"], []).append(
                [ev["step"] if ev["step"] is not None else -1, ev["value"]])
    return {k: np.asarray(v) for k, v in out.items()}


@dataclasses.dataclass
class ExperimentContext:
    exp_id: str
    log_dir: str
    model_dir: str
    writer: MetricWriter
    logger: logging.Logger
    config: Optional[dict] = None

    @property
    def model_path(self) -> str:
        return os.path.join(self.model_dir, "model")

    def close(self):
        self.writer.close()
        for h in list(self.logger.handlers):  # release the log-file fd
            h.close()
            self.logger.removeHandler(h)


def _config_to_dict(config) -> dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {k: v for k, v in vars(config).items() if not k.startswith("_")}


def config_hash(config) -> str:
    """Deterministic short hash of a config for cache and run keying
    (``core.config.config_hash``, one hash function for both uses)."""
    from scd_tpu_torch.core.config import config_hash as _core_hash

    return _core_hash(_config_to_dict(config))


def init_experiment(config=None, exp_root: str = "runs",
                    runner_name: str = "scd", exp_id: Optional[str] = None
                    ) -> ExperimentContext:
    """Create a uniquely-named run directory with a metric writer, a log
    file, a checkpoints dir, and a persisted config (reference
    ``init_experiment``, ``general_utils.py:92-152``; the date + random id
    naming is kept so tooling that matches ``(dd.mm.yyyy_|_...)`` run ids
    keeps working)."""
    if exp_id is None:
        now = time.localtime()
        exp_id = (f"({now.tm_mday:02d}.{now.tm_mon:02d}.{now.tm_year}_|_"
                  f"{uuid.uuid4().hex[:6]})")
    log_dir = os.path.join(exp_root, runner_name, "log", exp_id)
    model_dir = os.path.join(log_dir, "checkpoints")
    os.makedirs(model_dir, exist_ok=True)

    logger = logging.getLogger(f"scd_tpu_torch.{exp_id}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.FileHandler(os.path.join(log_dir, "log.txt")),
              logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)

    writer = MetricWriter(log_dir)
    cfg_dict = _config_to_dict(config)
    if cfg_dict:
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump(cfg_dict, f, indent=2, sort_keys=True, default=str)
        writer.add_hparams(cfg_dict)
    logger.info("Experiment saved to: %s", log_dir)
    return ExperimentContext(exp_id=exp_id, log_dir=log_dir,
                             model_dir=model_dir, writer=writer,
                             logger=logger, config=cfg_dict or None)


class _NullWriter:
    """A :class:`MetricWriter` that writes nothing."""

    def add_scalar(self, *_a, **_k) -> None:
        pass

    add_scalars = add_hparams = add_scalar

    def close(self) -> None:
        pass


def follow_experiment(exp_id: str, exp_root: str = "runs",
                      runner_name: str = "scd") -> ExperimentContext:
    """The context of a run that another rank created with
    :func:`init_experiment` (the same ``exp_id``): its paths, a writer and
    a logger that write nothing, so a data-parallel run's ranks above 0
    neither print nor write beside rank 0."""
    log_dir = os.path.join(exp_root, runner_name, "log", exp_id)
    logger = logging.getLogger(f"scd_tpu_torch.{exp_id}.follower")
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return ExperimentContext(exp_id=exp_id, log_dir=log_dir,
                             model_dir=os.path.join(log_dir, "checkpoints"),
                             writer=_NullWriter(), logger=logger)


class AverageMeter:
    """Running average (reference ``cluster_utils.py:117-137``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class IndicatePlateau:
    """Signal when a tracked metric has plateaued (reference
    ``general_utils.py:273-330``): returns True from ``step`` once the
    metric fails to improve for ``patience_epochs`` consecutive steps, then
    resets."""

    def __init__(self, threshold: float = 5e-4, patience_epochs: int = 5,
                 mode: str = "min", threshold_mode: str = "rel"):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.patience = patience_epochs
        self.mode = mode
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self._reset()

    def _reset(self):
        self.best = math.inf if self.mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def is_better(self, a: float, best: float) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> bool:
        current = float(metric)
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self._reset()
            return True
        return False
