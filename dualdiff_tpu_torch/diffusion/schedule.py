"""DDPM noise schedule (SD v1.5: scaled_linear betas 0.00085..0.012, 1000
steps).  Port of ``dualdiff_tpu/diffusion/schedule.py``; the constants are
float32 numpy arrays, which the samplers read on the host."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DiffusionSchedule"]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray           # (T,) float32
    alphas_cumprod: np.ndarray  # (T,) float32
    num_train_timesteps: int = 1000

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear") -> "DiffusionSchedule":
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float32) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float32)
        else:
            raise ValueError(f"unknown beta schedule {beta_schedule}")
        alphas_cumprod = np.cumprod(1.0 - betas, dtype=np.float32)
        return cls(betas=betas, alphas_cumprod=alphas_cumprod,
                   num_train_timesteps=num_train_timesteps)
