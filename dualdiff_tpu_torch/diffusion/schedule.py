"""DDPM noise schedule (SD v1.5: scaled_linear betas 0.00085..0.012, 1000
steps).  Port of ``dualdiff_tpu/diffusion/schedule.py``; the constants are
float32 numpy arrays, which the samplers read on the host.  The training
forward process (``add_noise``, ``velocity``, ``training_target``,
``pred_x0_from_eps``) gathers them on the timesteps' device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DiffusionSchedule"]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray           # (T,) float32
    alphas_cumprod: np.ndarray  # (T,) float32
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear",
               prediction_type: str = "epsilon") -> "DiffusionSchedule":
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
                   num_train_timesteps=num_train_timesteps,
                   prediction_type=prediction_type)

    def _coefs(self, t: torch.Tensor, ndim: int):
        """sqrt(abar_t) and sqrt(1 - abar_t), float32, shaped to broadcast
        against a tensor of ``ndim`` dims whose leading dims are t's."""
        abar = torch.as_tensor(self.alphas_cumprod, device=t.device)[t.long()]
        abar = abar.reshape(*t.shape, *([1] * (ndim - t.dim())))
        return abar.sqrt(), (1.0 - abar).sqrt()

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) sample in float32; t (B,) or (B, N) prefixes x0's
        shape (per-view timesteps need no reshape)."""
        a, s = self._coefs(t, x0.dim())
        return a * x0.float() + s * noise.float()

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """v-prediction target (diffusers ``get_velocity``)."""
        a, s = self._coefs(t, x0.dim())
        return a * noise.float() - s * x0.float()

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.velocity(x0, noise, t)
        raise ValueError(f"Unknown prediction type {self.prediction_type}")

    def pred_x0_from_eps(self, x_t: torch.Tensor, eps: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        """The denoised prediction (x_t - sqrt(1 - abar_t) eps) /
        sqrt(abar_t), in float32 (the RGD reward's input)."""
        a, s = self._coefs(t, x_t.dim())
        return (x_t.float() - s * eps.float()) / a
