"""PNDM (PLMS), DDIM and LMS schedulers, counterparts of
``ldiffusion_tpu/diffusion/schedulers.py``. PyTorch runs eagerly, so each
state's counter is a Python int and the branch on it is a Python ``if``; the
per-step scalars are float32 as in the JAX package.

- PNDM with skip_prk_steps=True (PLMS), SD v1.5's scheduler. Quirk kept:
  with one inference step it visits t=1 with prev_t=-999, whose alpha_bar is
  ``final_alpha_cumprod`` (alpha_bar[0] in the SD v1.5 config).
- DDIM, deterministic (eta = 0).
- LMS (diffusers' LMSDiscreteScheduler): sigmas interpolated at the visited
  timesteps and the linear-multistep coefficients integrated with scipy's
  ``quad`` on the host at ``set_timesteps``, the same calls as the JAX
  package's, so the table is bit-equal; ``step`` and ``scale_model_input``
  take the loop index, not the timestep.

Laplace noise (``add_laplace_noise``) is an explicit tensor or is drawn from a
``torch.Generator``; a generator cannot replay a JAX key, so tests hand in
the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ldiffusion_tpu_torch.diffusion.schedule import NoiseSchedule, sd15_schedule


def laplace_noise(shape, generator: Optional[torch.Generator], device=None,
                  dtype=torch.float32):
    """Laplace(0, 1) samples by the inverse CDF, as ``jax.random.laplace``:
    u ~ U(−1 + ε, 1), x = sign(u)·log1p(−|u|)."""
    u = torch.empty(shape, device=device, dtype=dtype)
    u.uniform_(-1.0 + torch.finfo(dtype).eps / 2, 1.0, generator=generator)
    return torch.sign(u) * torch.log1p(-u.abs())


@dataclasses.dataclass(frozen=True)
class Timesteps:
    """``values``: training-step indices visited, in sampling order."""

    values: Tuple[int, ...]
    num_inference_steps: int
    step_ratio: int

    def __len__(self) -> int:
        return len(self.values)

    @property
    def array(self) -> np.ndarray:
        return np.asarray(self.values, dtype=np.int32)


class PNDMState(NamedTuple):
    ets: List               # model outputs kept for the multistep formula, newest last
    counter: int
    cur_sample: Optional[object]  # the sample stashed at counter 0 for the counter-1 fixup


class DDIMState(NamedTuple):
    counter: int


class LMSState(NamedTuple):
    derivatives: List       # the last ``order`` derivatives, newest last
    counter: int


class _SchedulerBase:
    order = 1

    def __init__(self, schedule: Optional[NoiseSchedule] = None):
        self.schedule = schedule or sd15_schedule()

    def _alpha(self, t: int) -> np.float32:
        """alpha_bar at a (possibly negative) timestep; negative → final."""
        if t >= 0:
            return np.float32(self.schedule.alphas_cumprod[min(t, self.schedule.num_train_timesteps - 1)])
        return np.float32(self.schedule.final_alpha_cumprod)

    def add_laplace_noise(self, sample, t: int, noise=None,
                          generator: Optional[torch.Generator] = None):
        """sample + Laplace(0, sqrt(1 − alpha_bar_t)): ``noise`` is a unit
        Laplace draw of the sample's shape, else drawn from ``generator``."""
        scale = float(np.sqrt(np.float32(1.0) - self._alpha(t)))
        if noise is None:
            noise = laplace_noise(sample.shape, generator, sample.device, sample.dtype)
        return sample + noise.to(sample.device, sample.dtype) * scale

    def scale_model_input(self, sample, t=None):
        return sample  # identity for PNDM and DDIM


class PNDMScheduler(_SchedulerBase):
    """PLMS (PNDM with skip_prk_steps=True), SD v1.5's default scheduler."""

    def set_timesteps(self, num_inference_steps: int) -> Timesteps:
        T = self.schedule.num_train_timesteps
        num_inference_steps = min(num_inference_steps, T)
        ratio = T // num_inference_steps
        base = (np.arange(0, num_inference_steps) * ratio).round().astype(np.int64)
        base += self.schedule.steps_offset
        # PLMS repeats the second-to-last step: n > 1 steps visit n + 1 timesteps
        if num_inference_steps > 1:
            plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        else:
            plms = base[::-1]
        return Timesteps(tuple(int(t) for t in plms), num_inference_steps, ratio)

    def init_state(self) -> PNDMState:
        return PNDMState(ets=[], counter=0, cur_sample=None)

    def step(self, ts: Timesteps, state: PNDMState, model_output, t: int, sample):
        """One PLMS reverse step → (previous sample, new state)."""
        ratio = ts.step_ratio
        counter = state.counter
        ets = state.ets if counter == 1 else (state.ets + [model_output])[-4:]
        prev_t = t if counter == 1 else t - ratio
        t_eff = t + ratio if counter == 1 else t
        if counter == 0:
            mo = model_output
        elif counter == 1:
            mo = (model_output + ets[-1]) / 2
        elif counter == 2:
            mo = (3 * ets[-1] - ets[-2]) / 2
        elif counter == 3:
            mo = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            mo = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        sample_eff = state.cur_sample if counter == 1 else sample
        cur_sample = sample if counter == 0 else state.cur_sample
        prev = self._get_prev_sample(sample_eff, t_eff, prev_t, mo)
        return prev, PNDMState(ets=ets, counter=counter + 1, cur_sample=cur_sample)

    def _get_prev_sample(self, sample, t: int, prev_t: int, model_output):
        a_t, a_prev = self._alpha(t), self._alpha(prev_t)
        b_t, b_prev = np.float32(1.0) - a_t, np.float32(1.0) - a_prev
        sample_coeff = np.sqrt(a_prev / a_t)
        denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
        return float(sample_coeff) * sample - float(a_prev - a_t) * model_output / float(denom)


class DDIMScheduler(_SchedulerBase):
    """Deterministic DDIM (eta = 0)."""

    def set_timesteps(self, num_inference_steps: int) -> Timesteps:
        T = self.schedule.num_train_timesteps
        ratio = T // num_inference_steps
        tsv = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        tsv += self.schedule.steps_offset
        return Timesteps(tuple(int(t) for t in tsv), num_inference_steps, ratio)

    def init_state(self) -> DDIMState:
        return DDIMState(counter=0)

    def step(self, ts: Timesteps, state: DDIMState, model_output, t: int, sample):
        a_t, a_prev = self._alpha(t), self._alpha(t - ts.step_ratio)
        one = np.float32(1.0)
        pred_x0 = (sample - float(np.sqrt(one - a_t)) * model_output) / float(np.sqrt(a_t))
        direction = float(np.sqrt(one - a_prev)) * model_output
        prev = float(np.sqrt(a_prev)) * pred_x0 + direction
        return prev, DDIMState(counter=state.counter + 1)


class LMSScheduler(_SchedulerBase):
    """Linear multistep (k-diffusion style) over interpolated sigmas, as
    diffusers' LMSDiscreteScheduler. ``set_timesteps`` keeps the sigmas and
    the coefficient table on the scheduler for the steps that follow."""

    def __init__(self, schedule: Optional[NoiseSchedule] = None, order: int = 4):
        super().__init__(schedule)
        self.lms_order = order

    def set_timesteps(self, num_inference_steps: int) -> Timesteps:
        tsv, sigmas, coeffs = self._tables(num_inference_steps)
        # the steps read float32 tables, as the JAX package's do
        self._sigmas = sigmas.astype(np.float32)
        self._coeffs = coeffs.astype(np.float32)
        T = self.schedule.num_train_timesteps
        return Timesteps(tuple(int(round(t)) for t in tsv), num_inference_steps,
                         max(1, T // num_inference_steps))

    def _tables(self, n: int):
        """float64 (timesteps (n,), sigmas (n + 1,), coefficients (n, order))."""
        T = self.schedule.num_train_timesteps
        tsv = np.linspace(0, T - 1, n, dtype=np.float64)[::-1]
        sigmas = np.interp(tsv[::-1], np.arange(T), self.schedule.sigmas)[::-1]
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float64)
        return tsv, sigmas, self._lms_coeff_table(sigmas, n)

    def _lms_coeff_table(self, sigmas: np.ndarray, n: int) -> np.ndarray:
        """(n, order) float64: ``[step, cur]`` multiplies derivative step − cur."""
        from scipy import integrate

        table = np.zeros((n, self.lms_order), dtype=np.float64)
        for step in range(n):
            order = min(step + 1, self.lms_order)
            for cur in range(order):
                def fn(tau, cur=cur, step=step, order=order):
                    prod = 1.0
                    for k in range(order):
                        if cur == k:
                            continue
                        prod *= (tau - sigmas[step - k]) / (sigmas[step - cur] - sigmas[step - k])
                    return prod

                table[step, cur] = integrate.quad(
                    fn, sigmas[step], sigmas[step + 1], epsrel=1e-4)[0]
        return table

    def init_state(self) -> LMSState:
        return LMSState(derivatives=[], counter=0)

    def scale_model_input(self, sample, step_index: int):
        sigma = self._sigmas[step_index]
        return sample / float(np.sqrt(sigma ** 2 + np.float32(1.0)))

    def step(self, ts: Timesteps, state: LMSState, model_output, step_index: int, sample):
        """``step_index`` is the loop index (0..n-1), not the timestep value."""
        sigma = float(self._sigmas[step_index])
        pred_x0 = sample - sigma * model_output
        deriv = (sample - pred_x0) / sigma
        derivs = (state.derivatives + [deriv])[-self.lms_order:]
        coeffs = self._coeffs[step_index]
        # the JAX package sums all ``order`` terms over a zero-padded history;
        # the missing terms are 0·0 and change nothing
        contrib = sum(float(coeffs[cur]) * derivs[-1 - cur] for cur in range(len(derivs)))
        return sample + contrib, LMSState(derivatives=derivs, counter=state.counter + 1)


def make_scheduler(name: str = "pndm", schedule: Optional[NoiseSchedule] = None):
    name = name.lower()
    if name in ("pndm", "plms"):
        return PNDMScheduler(schedule)
    if name == "ddim":
        return DDIMScheduler(schedule)
    if name in ("lms", "lmsdiscrete"):
        return LMSScheduler(schedule)
    raise ValueError(f"unknown scheduler: {name}")
