"""Learning-rate schedules, evaluated on the host.

Port of segs_slam_tpu/train/schedules.py: expon_lr is the log-linear
interpolation with optional sin-delay warm-up used for every scheduled group
(reference: GaussianModel::getExponLrFunc, src/gaussian_model.cpp:1393-1409).
The step counter lives on the host, so a schedule is a plain function of an
int. The arithmetic is float32, as the JAX version's is, and the result a
Python float holding that float32 value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_F = np.float32


@dataclasses.dataclass(frozen=True)
class ExponLR:
    lr_init: float
    lr_final: float
    lr_delay_steps: int = 0
    lr_delay_mult: float = 1.0
    max_steps: int = 30_000

    def __call__(self, step: int) -> float:
        if self.lr_init == 0.0 and self.lr_final == 0.0:
            return 0.0
        step = _F(step)
        with np.errstate(divide="ignore"):  # log(0) = -inf, as in JAX
            if self.lr_delay_steps > 0:
                delay_rate = _F(self.lr_delay_mult) + _F(
                    1.0 - self.lr_delay_mult) * np.sin(
                        _F(0.5 * np.pi) * np.clip(
                            step / _F(self.lr_delay_steps), _F(0), _F(1)))
            else:
                delay_rate = _F(1.0)
            t = np.clip(step / _F(self.max_steps), _F(0), _F(1))
            log_lerp = np.exp(np.log(_F(self.lr_init)) * (_F(1) - t)
                              + np.log(_F(self.lr_final)) * t)
        lr = delay_rate * log_lerp
        return 0.0 if step < 0 else float(lr)


@dataclasses.dataclass(frozen=True)
class ConstantLR:
    lr: float

    def __call__(self, step: int) -> float:
        return float(_F(self.lr))
