"""Noise schedule, the PNDM / DDIM / LMS schedulers, the one-step diffusion
transform and the depth-conditioned multimodal augment."""
from ldiffusion_tpu_torch.diffusion.schedule import NoiseSchedule, sd15_schedule  # noqa: F401
from ldiffusion_tpu_torch.diffusion.schedulers import (  # noqa: F401
    DDIMScheduler,
    LMSScheduler,
    PNDMScheduler,
    make_scheduler,
)
