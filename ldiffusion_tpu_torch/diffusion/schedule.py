"""Noise schedule of Stable-Diffusion v1.5 (counterpart of
``ldiffusion_tpu/diffusion/schedule.py``).

SD v1.5 trains with a "scaled_linear" beta schedule: betas are the squares of
a linspace between sqrt(0.00085) and sqrt(0.012) over 1000 steps. The
cumulative products alpha_bar are taken in float64 and stored as float32;
``sigmas`` (the LMS scheduler's) and ``laplace_scale`` (the Laplace noising's
sqrt(1 − alpha_bar_t)) are computed from that float32 table, as the JAX
package computes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int
    betas: np.ndarray            # (T,) float32
    alphas: np.ndarray           # (T,) float32
    alphas_cumprod: np.ndarray   # (T,) float32
    steps_offset: int = 1        # SD v1.5 scheduler config
    set_alpha_to_one: bool = False

    @property
    def final_alpha_cumprod(self) -> float:
        # set_alpha_to_one=False in the SD v1.5 config: use alpha_bar[0]
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    def laplace_scale(self, t) -> np.ndarray:
        """sqrt(1 − alpha_bar_t), the Laplace noise scale of the warm-up loop."""
        return np.sqrt(1.0 - self.alphas_cumprod[t])

    @property
    def sigmas(self) -> np.ndarray:
        """sqrt((1 − alpha_bar) / alpha_bar), the LMS scheduler's sigmas."""
        return np.sqrt((1.0 - self.alphas_cumprod) / self.alphas_cumprod)


def scaled_linear_schedule(beta_start: float = 0.00085, beta_end: float = 0.012,
                           num_train_timesteps: int = 1000, steps_offset: int = 1,
                           set_alpha_to_one: bool = False) -> NoiseSchedule:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    alphas = 1.0 - betas
    return NoiseSchedule(
        num_train_timesteps=num_train_timesteps,
        betas=betas.astype(np.float32),
        alphas=alphas.astype(np.float32),
        alphas_cumprod=np.cumprod(alphas, dtype=np.float64).astype(np.float32),
        steps_offset=steps_offset,
        set_alpha_to_one=set_alpha_to_one)


def sd15_schedule() -> NoiseSchedule:
    """The schedule shipped with SD v1.5 (PNDM scheduler config)."""
    return scaled_linear_schedule()
