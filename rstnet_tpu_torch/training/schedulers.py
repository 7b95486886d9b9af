"""Learning-rate schedules, ``step -> lr`` (counterpart of
``rstnet_tpu/training/schedulers.py``), computed in float32 as the JAX
schedules are. ``step`` is the optimizer's update count before the update
(optax's ``scale_by_schedule`` count)."""

from __future__ import annotations

import numpy as np


def warmup_lr(base_lr: float, warmup_steps: int = 25000):
    """lr(step) = base_lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) with
    s = step + 1 (so step 0 maps to 1); the peak, base_lr, is at s = warmup."""

    def schedule(step):
        s = np.maximum(np.float32(step) + np.float32(1.0), np.float32(1.0))
        return np.float32(base_lr * warmup_steps**0.5) * np.minimum(
            s ** np.float32(-0.5), s * np.float32(warmup_steps**-1.5))

    return schedule


def constant_lr(base_lr: float):
    return lambda step: np.float32(base_lr)


def exponential_decay_lr(base_lr: float, gamma: float, steps_per_epoch: int = 1):
    """lr decays by ``gamma`` per epoch of ``steps_per_epoch`` steps."""

    def schedule(step):
        return np.float32(base_lr) * np.float32(gamma) ** (np.float32(step) / steps_per_epoch)

    return schedule
