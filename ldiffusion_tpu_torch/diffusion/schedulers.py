"""PNDM (PLMS) scheduler, counterpart of ``PNDMScheduler`` in
``ldiffusion_tpu/diffusion/schedulers.py``. PyTorch runs eagerly, so the
state's counter is a Python int and the branch on it is a Python ``if``; the
per-step scalars are float32 as in the JAX package. DDIM and LMS wait
(ROADMAP queue 1, *The generation tail*).

Quirk kept: with one inference step PNDM visits t=1 with prev_t=-999, whose
alpha_bar is ``final_alpha_cumprod`` (alpha_bar[0] in the SD v1.5 config).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ldiffusion_tpu_torch.diffusion.schedule import NoiseSchedule, sd15_schedule


@dataclasses.dataclass(frozen=True)
class Timesteps:
    """``values``: training-step indices visited, in sampling order."""

    values: Tuple[int, ...]
    num_inference_steps: int
    step_ratio: int

    def __len__(self) -> int:
        return len(self.values)


class PNDMState(NamedTuple):
    ets: List               # model outputs kept for the multistep formula, newest last
    counter: int
    cur_sample: Optional[object]  # the sample stashed at counter 0 for the counter-1 fixup


class PNDMScheduler:
    """PLMS (PNDM with skip_prk_steps=True), SD v1.5's default scheduler."""

    def __init__(self, schedule: Optional[NoiseSchedule] = None):
        self.schedule = schedule or sd15_schedule()

    def _alpha(self, t: int) -> np.float32:
        """alpha_bar at a (possibly negative) timestep; negative → final."""
        if t >= 0:
            return np.float32(self.schedule.alphas_cumprod[min(t, self.schedule.num_train_timesteps - 1)])
        return np.float32(self.schedule.final_alpha_cumprod)

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
