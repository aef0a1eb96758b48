"""LR schedules and ramp functions.

Port of ``scd_tpu/train/schedulers.py`` (reference
``gcd/project_utils/schedulers.py``, ``local_utils/ramps.py``).  The JAX
package builds its functional schedules from optax; here each is a plain
function of the step count that gives optax's value by optax's formula
(``cosine_decay_schedule``: the step clipped to ``decay_steps``, ``lr *
((1 - alpha) * 0.5 * (1 + cos(pi t / T)) + alpha)``;
``warmup_cosine_decay_schedule``: a linear ramp from 0 for
``warmup_steps``, then that cosine over the rest; ``piecewise_constant``:
each scale applied from its boundary on).  Values are Python floats.  The
plateau controllers run on the host, per epoch.
"""

from __future__ import annotations

import math

import numpy as np


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def fn(step) -> float:
        t = min(float(step), float(decay_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cos + alpha)
    return fn


def cosine_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, final_lr: float = 0.0):
    """Linear warmup then cosine decay."""
    if warmup_steps > 0:
        alpha = 0.0 if base_lr == 0.0 else final_lr / base_lr
        decay = _cosine_decay(base_lr, total_steps - warmup_steps, alpha)

        def fn(step) -> float:
            if step < warmup_steps:  # optax.linear_schedule from 0
                frac = 1.0 - min(max(float(step), 0.0), warmup_steps) \
                    / warmup_steps
                return (0.0 - base_lr) * frac + base_lr
            return decay(step - warmup_steps)
        return fn
    return _cosine_decay(base_lr, total_steps,
                         alpha=final_lr / max(base_lr, 1e-12))


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential rampup from Tarvainen & Valpola."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return float(np.clip(current / rampup_length, 0.0, 1.0))


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))


def step_schedule(base_lr: float, step_size: int = 150, gamma: float = 0.1):
    """StepLR."""
    def fn(step) -> float:
        return base_lr * gamma ** (int(step) // step_size)
    return fn


def multi_step_schedule(base_lr: float, milestones):
    """MultiStepLR: x0.1 from each distinct milestone on (optax's
    piecewise constant schedule over ``{m: 0.1}``)."""
    bounds = sorted({int(m) for m in milestones})

    def fn(step) -> float:
        v = base_lr
        for m in bounds:
            if step >= m:
                v = 0.1 * v
        return v
    return fn


def cosine_annealing_schedule(base_lr: float, total_steps: int,
                              eta_min: float = 0.0):
    """CosineAnnealingLR down to ``eta_min``."""
    return _cosine_decay(base_lr, total_steps,
                         alpha=eta_min / max(base_lr, 1e-12))


def cosine_warm_restarts_schedule(base_lr: float, t0: int,
                                  eta_min: float = 0.0,
                                  warmup_steps: int = 0):
    """CosineAnnealingWarmRestarts with a fixed period ``t0``, optionally
    after a linear warmup up to the cosine curve's value at
    ``warmup_steps``."""
    def cos_val(step) -> float:
        t_cur = float(step) % t0
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t_cur / t0))

    if warmup_steps <= 0:
        return cos_val
    target = cos_val(warmup_steps)

    def fn(step) -> float:
        if step < warmup_steps:
            return eta_min + (target - eta_min) * (step + 1) / warmup_steps
        return cos_val(step)
    return fn


class ReduceLROnPlateau:
    """Host-side plateau controller: call ``step(metric)`` per epoch and
    multiply ``scale`` into the base lr (torch's semantics, mode 'min',
    patience 50 in the reference)."""

    def __init__(self, factor: float = 0.1, patience: int = 50,
                 threshold: float = 1e-4, mode: str = "min",
                 threshold_mode: str = "rel", min_scale: float = 1e-8):
        from scd_tpu_torch.utils.experiment import IndicatePlateau

        self._plateau = IndicatePlateau(threshold=threshold,
                                        patience_epochs=patience, mode=mode,
                                        threshold_mode=threshold_mode)
        self.factor = factor
        self.min_scale = min_scale
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if self._plateau.step(metric):
            self.scale = max(self.scale * self.factor, self.min_scale)
        return self.scale


class WarmRestartPlateau(ReduceLROnPlateau):
    """Plateau reduction that resets to the base lr every ``t_restart``
    epochs."""

    def __init__(self, t_restart: int = 120, **kw):
        super().__init__(**kw)
        self.t_restart = t_restart
        self._epoch = 0

    def step(self, metric: float) -> float:
        super().step(metric)
        self._epoch += 1
        if self._epoch % self.t_restart == 0:
            self.scale = 1.0
            self._plateau._reset()
        return self.scale


def get_scheduler(name: str, base_lr: float, total_steps: int, **kw):
    """The reference's ``get_scheduler`` dispatcher: a function of the
    step for the functional schedules, a host controller for the plateau
    family."""
    if name == "step":
        return step_schedule(base_lr, kw.get("step_size", 150),
                             kw.get("gamma", 0.1))
    if name == "multi_step":
        return multi_step_schedule(
            base_lr, kw.get("milestones", [30 * i for i in range(1, 5)]))
    if name == "cosine":
        return cosine_annealing_schedule(base_lr, total_steps,
                                         kw.get("eta_min", base_lr * 1e-3))
    if name in ("cosine_warm_restarts", "cosine_warm_restarts_warmup"):
        num_restarts = kw.get("num_restarts", 2)
        t0 = kw.get("t0", max(int(total_steps / (num_restarts + 1)), 1))
        warmup = kw.get("warmup_steps",
                        10 if name.endswith("warmup") else 0)
        return cosine_warm_restarts_schedule(
            base_lr, t0, kw.get("eta_min", base_lr * 1e-3), warmup)
    if name == "plateau":
        return ReduceLROnPlateau(patience=kw.get("patience", 50))
    if name == "warm_restarts_plateau":
        return WarmRestartPlateau(
            t_restart=kw.get("t_restart", 120), mode="min",
            threshold_mode="abs", threshold=kw.get("threshold", 0.5),
            patience=kw.get("patience", 100))
    raise NotImplementedError(name)
