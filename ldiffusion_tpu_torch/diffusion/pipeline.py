"""SD components and the two transforms (counterpart of
``ldiffusion_tpu/diffusion/pipeline.py``).

``one_step_transform``: VAE encode → PNDM ``set_timesteps(1)`` → one UNet
pass → scheduler step → ``decode_latents`` → [0, 1] image. Quirks kept:
the ImageNet-normalised image is encoded as it is; latents are the raw VAE
mean (not scaled by 0.18215) while ``decode_latents`` divides by 0.18215.

``trajectory_features``: the stage-1 warm-up forward. Per PLMS timestep t
(``num_inference_steps`` give ``num_inference_steps + 1`` of them), the same
clean latents plus Laplace noise scaled by sqrt(1 − ᾱ_t) go through the
UNet, whose raw output is decoded as latents (``vae.decode``, not as an
epsilon prediction), resized to 64² and reduced to gray; the grays stack
along channels. The noise is an input (``schedulers.laplace_noise`` draws it from a
generator), so ``torch.utils.checkpoint`` recomputes a timestep from the same
values, and tests can hand in the JAX package's draws.

``laplace_reverse_transform``: ``bench.py``'s program (``bench.py:88-106``),
encode → PNDM steps with Laplace noise through the UNet → ``decode_latents``.

Public functions take and return NHWC tensors, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.diffusion.schedulers import PNDMScheduler
from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ldiffusion_tpu_torch.models.convert import (
    clip_text_from_flax,
    load_sd_component,
    load_unet_dir,
    proj_from_flax,
    unet_from_flax,
    vae_from_flax,
)
from ldiffusion_tpu_torch.models.layers import cast_keeping_int8_weights, init_random_
from ldiffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from ldiffusion_tpu_torch.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ldiffusion_tpu_torch.ops.resize import resize_bilinear, rgb_to_gray

# The fixed conditioning prompt (reference ldiffusion.py:211, segmentor.py:93),
# and its ids under the CLIP vocab, [bos, a, pathological, slide, eos], used
# when a checkpoint directory has no tokenizer files.
DEFAULT_PROMPT = "A pathological slide"
DEFAULT_PROMPT_IDS = (49406, 320, 29018, 10556, 49407)


def apply_proj(proj: nn.Linear, emb):
    """The learned text projection Linear(768 → cross_attention_dim)."""
    return proj(emb.to(proj.weight.dtype))


def init_proj(generator: torch.Generator, in_dim: int, out_dim: int,
              device=None) -> nn.Linear:
    """torch nn.Linear's default init, U(-1/sqrt(in), 1/sqrt(in)), seeded.
    ``device``: None → the GPU (raises when there is none)."""
    proj = nn.Linear(in_dim, out_dim, device=resolve_device(device))
    bound = 1.0 / in_dim ** 0.5
    with torch.no_grad():
        for p in (proj.weight, proj.bias):
            u = torch.rand(p.shape, generator=generator, device=p.device)
            p.copy_(u * 2 * bound - bound)
    return proj


@dataclasses.dataclass
class SDComponents:
    """UNet + VAE + CLIP text encoder + text projection + scheduler."""

    unet_config: UNet2DConditionConfig
    vae_config: VAEConfig
    text_config: CLIPTextConfig
    unet: UNet2DCondition
    vae: AutoencoderKL
    text: CLIPTextEncoder
    proj: nn.Linear
    scheduler: PNDMScheduler = dataclasses.field(default_factory=PNDMScheduler)
    prompt_ids: tuple = DEFAULT_PROMPT_IDS
    tokenizer: Optional[CLIPTokenizer] = None
    _prompt_ids_cache: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                           compare=False)

    @staticmethod
    def _configs(unet_config, vae_config, text_config):
        unet_cfg = unet_config or UNet2DConditionConfig.tiny()
        vae_cfg = vae_config or VAEConfig.tiny()
        # the tiny text tower keeps the full vocabulary: the prompt ids are real
        text_cfg = text_config or dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=49408)
        return unet_cfg, vae_cfg, text_cfg

    @classmethod
    def _build(cls, unet_cfg, vae_cfg, text_cfg, device) -> "SDComponents":
        with torch.device("meta"):
            unet, vae, text = UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextEncoder(text_cfg)
            proj = nn.Linear(text_cfg.hidden_size, unet_cfg.cross_attention_dim)
        mods = [m.to_empty(device=device).eval() for m in (unet, vae, text, proj)]
        return cls(unet_cfg, vae_cfg, text_cfg, *mods)

    @classmethod
    def random(cls, seed: int = 0, dtype=torch.float32, device=None, unet_config=None,
               vae_config=None, text_config=None) -> "SDComponents":
        """Seeded random weights (tiny configs unless given), drawn on
        ``device`` (None → the GPU, raises when there is none)."""
        device = resolve_device(device)
        comps = cls._build(*cls._configs(unet_config, vae_config, text_config), device)
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in (comps.unet, comps.vae, comps.text):
            init_random_(m, gen)
        comps.proj.load_state_dict(init_proj(gen, comps.text_config.hidden_size,
                                             comps.unet_config.cross_attention_dim,
                                             device).state_dict())
        return comps.to(dtype=dtype)

    @classmethod
    def load(cls, model_dir: str, dtype=torch.bfloat16, device=None,
             unet_override_dir: Optional[str] = None) -> "SDComponents":
        """From a diffusers SD checkpoint directory (``unet/``, ``vae/``,
        ``text_encoder/``, optional ``tokenizer/``), on ``device`` (None → the
        GPU, raises when there is none), in ``dtype``. Every module loads with
        ``strict=True``: a missing or unknown key raises. The prompt ids come
        from ``tokenizer/`` when it exists, else ``DEFAULT_PROMPT_IDS``.

        ``unet_override_dir`` (a fine-tuned UNet in the JAX trainer's layout)
        replaces the UNet and, when it holds one, the text projection.
        Without one the projection is drawn from a ``torch.Generator`` seeded
        with 0; the JAX package draws it from ``jax.random.key(0)``
        (``ldiffusion_tpu/diffusion/pipeline.py:95-96``), which torch cannot
        reproduce, so the two packages agree on a directory only when the
        projection is carried (an override directory with
        ``proj_weights.npz``)."""
        device = resolve_device(device)
        loaded = {c: load_sd_component(model_dir, c) for c in ("unet", "vae", "text_encoder")}
        comps = cls._build(loaded["unet"][0], loaded["vae"][0], loaded["text_encoder"][0],
                           device)
        for module, component in ((comps.unet, "unet"), (comps.vae, "vae"),
                                  (comps.text, "text_encoder")):
            module.load_state_dict(loaded[component][1])
        del loaded
        gen = torch.Generator(device=device).manual_seed(0)
        comps.proj.load_state_dict(init_proj(gen, comps.text_config.hidden_size,
                                             comps.unet_config.cross_attention_dim,
                                             device).state_dict())
        try:
            tokenizer = CLIPTokenizer.from_pretrained(model_dir)
        except FileNotFoundError:  # no tokenizer files: DEFAULT_PROMPT_IDS
            pass
        else:
            comps.tokenizer = tokenizer
            comps.prompt_ids = tuple(tokenizer([DEFAULT_PROMPT])["input_ids"][0])
        comps.to(dtype=dtype)
        if unet_override_dir is not None:
            comps.load_unet_override(unet_override_dir)
        return comps

    def load_unet_override(self, path: str) -> "SDComponents":
        """Replace the UNet (and the text projection, when the directory holds
        one) with a fine-tuned UNet in the JAX trainer's layout, in the UNet's
        current dtype and device (reference ``segmentor.py:76-84``)."""
        cfg, unet_sd, proj_sd = load_unet_dir(path)
        dtype = self.unet.conv_in.weight.dtype
        with torch.device("meta"):
            unet = UNet2DCondition(cfg)
        unet.to_empty(device=self.device).load_state_dict(unet_sd)
        self.unet = cast_keeping_int8_weights(unet, dtype=dtype,
                                              memory_format=torch.channels_last).eval()
        self.unet_config = cfg
        if proj_sd is not None:
            self.proj.load_state_dict(proj_sd)
        return self

    @classmethod
    def from_flax(cls, params: dict, unet_config=None, vae_config=None, text_config=None,
                  dtype=torch.float32, device=None) -> "SDComponents":
        """From the JAX package's parameter trees {"unet", "vae", "text", "proj"},
        on ``device`` (None → the GPU, raises when there is none)."""
        comps = cls._build(*cls._configs(unet_config, vae_config, text_config),
                           resolve_device(device))
        comps.unet.load_state_dict(unet_from_flax(params["unet"], comps.unet_config))
        comps.vae.load_state_dict(vae_from_flax(params["vae"], comps.vae_config))
        comps.text.load_state_dict(clip_text_from_flax(params["text"],
                                                       comps.text_config.num_layers))
        comps.proj.load_state_dict(proj_from_flax(params["proj"]))
        return comps.to(dtype=dtype)

    def to(self, device=None, dtype=None) -> "SDComponents":
        """Move every module (in place); returns self. A cast down from f32
        keeps the int8 codes of the f32 weights (``cast_keeping_int8_weights``)."""
        for m in (self.unet, self.vae):
            cast_keeping_int8_weights(m, device=device, dtype=dtype,
                                      memory_format=torch.channels_last)
        for m in (self.text, self.proj):
            m.to(device=device, dtype=dtype)
        return self

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def text_embeddings(self, batch_size: int = 1, prompt: Optional[str] = None):
        """CLIP last_hidden_state → learned projection, (batch_size, S, D)
        (reference ``segmentor.py:54-60``): the fixed prompt's ids unless
        ``prompt`` is another text, which needs the directory's tokenizer."""
        if prompt is not None and prompt != DEFAULT_PROMPT:
            if self.tokenizer is None:
                raise ValueError("an arbitrary prompt needs tokenizer files")
            ids = self.tokenizer([prompt] * batch_size)["input_ids"]
        else:
            ids = [list(self.prompt_ids)] * batch_size
        ids = torch.tensor(ids, dtype=torch.long, device=self.device)
        return apply_proj(self.proj, self.text(ids))

    def prompt_id_tensor(self) -> torch.Tensor:
        """(1, S) int64 ids of ``prompt_ids`` on the device, made at the
        first call for these ids and device and kept: a captured training
        step reads them, and cannot hold the host-to-device copy that makes
        them."""
        key = (self.prompt_ids, self.device)
        if self._prompt_ids_cache is None or self._prompt_ids_cache[0] != key:
            ids = torch.tensor([list(self.prompt_ids)], dtype=torch.long, device=self.device)
            self._prompt_ids_cache = (key, ids)
        return self._prompt_ids_cache[1]

    @property
    def latent_factor(self) -> int:
        """Image size / latent size of the VAE (8 for SD v1.5)."""
        return 2 ** (len(self.vae_config.block_out_channels) - 1)


def trajectory_text_emb(components: SDComponents, batch_size: int):
    """Prompt embedding for the fixed prompt, computed at batch 1 and
    broadcast: CLIP last_hidden_state → learned projection. The text tower
    is frozen (no graph); the projection is trained."""
    with torch.no_grad():
        hidden = components.text(components.prompt_id_tensor())
    emb = apply_proj(components.proj, hidden)
    return emb.expand((batch_size,) + emb.shape[1:])


def trajectory_timesteps(components: SDComponents, num_inference_steps: int):
    """(timesteps, noise scales sqrt(1 − ᾱ_t) in float32) of the trajectory."""
    ts = components.scheduler.set_timesteps(max(1, num_inference_steps))
    acp = np.asarray(components.scheduler.schedule.alphas_cumprod, np.float32)
    return ts.values, [float(np.sqrt(np.float32(1.0) - acp[t])) for t in ts.values]


def trajectory_features(components: SDComponents, images, noise, num_inference_steps: int,
                        remat: bool = True):
    """The stage-1 forward pass (reference ``ldiffusion.py:209-252``).

    images: (B, H, W, 3) ImageNet-normalised; noise: (T, B, H/f, W/f, 4)
    unit Laplace draws, one per timestep (``laplace_noise``; f the VAE's
    factor). Returns (trajectory (B, 64, 64, T) gray decodes, final_rgb
    (B, 64, 64, 3) last decode), float32. With ``remat`` each timestep's
    activations are recomputed in the backward instead of kept.
    """
    timesteps, scales = trajectory_timesteps(components, num_inference_steps)
    if noise.shape[0] != len(timesteps):
        raise ValueError(f"noise has {noise.shape[0]} timesteps, the trajectory {len(timesteps)}")
    with torch.no_grad():
        latents = components.vae.encode_mean(images.permute(0, 3, 1, 2))
    emb = trajectory_text_emb(components, images.shape[0])

    def step(noisy, emb, t):
        rgb = components.vae.decode(components.unet(noisy, t, emb))
        rgb64 = resize_bilinear(rgb, (64, 64), channel_last=False).permute(0, 2, 3, 1)
        return rgb_to_gray(rgb64)[..., 0], rgb64

    grays, rgb64 = [], None
    for t, scale, eps in zip(timesteps, scales, noise):
        noisy = latents + eps.permute(0, 3, 1, 2).to(latents.dtype) * scale
        if remat:
            gray, rgb64 = checkpoint(step, noisy, emb, t, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            gray, rgb64 = step(noisy, emb, t)
        grays.append(gray)
    return torch.stack(grays, dim=-1), rgb64


def one_step_transform(components: SDComponents, images, text_emb):
    """images: (B, H, W, 3) ImageNet-normalised → (B, H, W, 3) in [0, 1], float32."""
    sch = components.scheduler
    ts = sch.set_timesteps(1)
    t = ts.values[0]
    x = images.permute(0, 3, 1, 2)
    latents = components.vae.encode_mean(x)
    eps = components.unet(latents, t, text_emb)
    latents, _ = sch.step(ts, sch.init_state(), eps, t, latents)
    return components.vae.decode_latents(latents).permute(0, 2, 3, 1)


def laplace_reverse_transform(components: SDComponents, images, num_inference_steps: int = 5,
                              noise=None, generator: Optional[torch.Generator] = None):
    """``bench.py``'s program: the fixed prompt's embedding, VAE
    ``encode_mean``, then at every PNDM visit (n steps visit n + 1
    timesteps) unit Laplace noise × sqrt(1 − ᾱ_t) added to the current
    latents, the UNet's prediction from them and the scheduler's step;
    ``decode_latents`` at the end. images: (B, H, W, 3) ImageNet-normalised;
    noise: (visits, B, H/f, W/f, 4) unit Laplace draws, else drawn from
    ``generator``. Returns (B, H, W, 3) in [0, 1], float32."""
    sch = components.scheduler
    ts = sch.set_timesteps(num_inference_steps)
    emb = trajectory_text_emb(components, images.shape[0])
    latents = components.vae.encode_mean(images.permute(0, 3, 1, 2))
    state = sch.init_state()
    for i, t in enumerate(ts.values):
        draw = None if noise is None else torch.as_tensor(noise[i]).permute(0, 3, 1, 2)
        eps = components.unet(sch.add_laplace_noise(latents, t, draw, generator), t, emb)
        latents, state = sch.step(ts, state, eps, t, latents)
    return components.vae.decode_latents(latents).permute(0, 2, 3, 1)
