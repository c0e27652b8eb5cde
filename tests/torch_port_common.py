"""Shared set-up of the ``test_torch_port_*`` files (not a test module)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ldiffusion_tpu.diffusion.pipeline import SDComponents, init_proj
from ldiffusion_tpu.losses import infonce as jinfo
from ldiffusion_tpu.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ldiffusion_tpu.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu.models.vae import AutoencoderKL, VAEConfig


def jax_random_components() -> SDComponents:
    """What ``SDComponents.random(image_size=64)`` builds — the same configs,
    keys and initialisers — with each flax init jitted (one compile each
    instead of op-by-op dispatch, several times faster on the CPU)."""
    ucfg, vcfg = UNet2DConditionConfig.tiny(), VAEConfig.tiny()
    tcfg = dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=49408)
    unet, vae, text = UNet2DCondition(ucfg), AutoencoderKL(vcfg), CLIPTextEncoder(tcfg)
    r1, r2, r3, r4 = jax.random.split(jax.random.key(0), 4)
    params = {
        "unet": jax.jit(unet.init)(r1, jnp.zeros((1, 8, 8, 4)), jnp.int32(1),
                                   jnp.zeros((1, 5, 32)))["params"],
        "vae": jax.jit(vae.init)(r2, jnp.zeros((1, 64, 64, 3)))["params"],
        "text": jax.jit(text.init)(r3, jnp.zeros((1, 5), jnp.int32))["params"],
        "proj": init_proj(r4, tcfg.hidden_size, ucfg.cross_attention_dim),
    }
    return SDComponents(unet_config=ucfg, vae_config=vcfg, text_config=tcfg, unet=unet,
                        vae=vae, text=text, params=params)


def jax_components_of(components) -> SDComponents:
    """The JAX package's components at the port's ``components``' configs
    holding their weights (carried with ``*_to_flax``): no flax init to
    compile, and the same weights on both sides by construction."""
    from ldiffusion_tpu_torch.models import convert

    ucfg = UNet2DConditionConfig(**dataclasses.asdict(components.unet_config))
    vcfg = VAEConfig(**dataclasses.asdict(components.vae_config))
    tcfg = CLIPTextConfig(**dataclasses.asdict(components.text_config))
    params = {
        "unet": convert.unet_to_flax(components.unet.state_dict(), components.unet_config),
        "vae": convert.vae_to_flax(components.vae.state_dict(), components.vae_config),
        "text": convert.clip_text_to_flax(components.text.state_dict(), tcfg.num_layers),
        "proj": convert.proj_to_flax(components.proj.state_dict()),
    }
    return SDComponents(unet_config=ucfg, vae_config=vcfg, text_config=tcfg,
                        unet=UNet2DCondition(ucfg), vae=AutoencoderKL(vcfg),
                        text=CLIPTextEncoder(tcfg), params=params)


class JittedModule:
    """A flax module whose ``apply`` (each ``method``) is jitted: the JAX
    tools call ``module.apply`` op by op, which is several times slower on the
    CPU than one compile."""

    def __init__(self, module):
        self.module, self.compiled = module, {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, variables, *args, method=None, **kwargs):
        name = getattr(method, "__name__", "__call__")
        if name not in self.compiled:
            m = self.module
            self.compiled[name] = jax.jit(
                lambda v, *a, **k: m.apply(v, *a, method=getattr(m, name), **k))
        return self.compiled[name](variables, *args, **kwargs)


def jitted(components: SDComponents) -> SDComponents:
    """The same components (configs, params, scheduler) with jitted modules."""
    return dataclasses.replace(components, unet=JittedModule(components.unet),
                               vae=JittedModule(components.vae),
                               text=JittedModule(components.text))


def jax_contrast_indices(labels, key, num_negatives, num_anchors, num_classes):
    """The anchors, positives, negatives and validity ``contrastive_loss`` of
    the JAX package draws from ``key`` (the same splits and formulas,
    ldiffusion_tpu/losses/infonce.py:60-90), as numpy."""
    b = labels.shape[0]
    labs = jnp.asarray(labels).reshape(b, -1)
    n = labs.shape[1]
    out = []
    for lab, k in zip(labs, jax.random.split(key, b)):
        k_anchor, k_pos, k_neg, k_cls = jax.random.split(k, 4)
        if num_classes is None:
            anchor = jax.random.randint(k_anchor, (num_anchors,), 0, n)
            present = jnp.ones((num_anchors,), bool)
        else:
            class_mask = lab[None, :] == jnp.arange(num_classes)[:, None]
            scores = jnp.where(class_mask, jinfo._gumbel(k_cls, (num_classes, n)), -jnp.inf)
            uniform = jax.random.randint(k_anchor, (num_anchors - num_classes,), 0, n)
            anchor = jnp.concatenate([jnp.argmax(scores, axis=1), uniform])
            present = jnp.concatenate([class_mask.any(axis=1),
                                       jnp.ones((num_anchors - num_classes,), bool)])
        same = lab[None, :] == lab[anchor][:, None]
        n_same = jnp.sum(same, axis=1)
        valid = present & (n_same > 1) & (n - n_same > num_negatives)
        pos_mask = same.at[jnp.arange(num_anchors), anchor].set(False)
        pos = jnp.argmax(jnp.where(pos_mask, jinfo._gumbel(k_pos, (num_anchors, n)), -jnp.inf),
                         axis=1)
        neg = jax.random.categorical(k_neg, jnp.where(~same, 0.0, -jnp.inf)[:, None, :],
                                     axis=-1, shape=(num_anchors, num_negatives))
        out.append([np.asarray(a) for a in (anchor, pos, neg, valid)])
    return [np.stack(x) for x in zip(*out)]


def jax_laplace_noise(key, n_steps: int, shape):
    """The unit Laplace draws ``trajectory_features`` of the JAX package takes
    from ``key``, one per timestep (``split(key, T)``, pipeline.py:203-217),
    stacked: (T, *shape) numpy."""
    return np.stack([np.asarray(jax.random.laplace(k, shape, jnp.float32))
                     for k in jax.random.split(key, n_steps)])


def random_params(tree, rng):
    """A flax tree of the same shapes, every leaf drawn non-zero from ``rng``:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), running variances in
    [0.5, 1.5), the rest (biases, running means, ConvNeXt gammas) N(0, 0.1²).
    A fresh flax init zeroes biases, the ControlNet's zero convolutions and
    ``cond_out``, and sets gammas to 1e-6, which would hide what they feed."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng)
            continue
        if k == "kernel":
            w = rng.normal(size=v.shape) / math.sqrt(math.prod(v.shape[:-1]))
        elif k == "scale":
            w = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif k == "var":
            w = 0.5 + rng.random(v.shape)
        else:
            w = 0.1 * rng.normal(size=v.shape)
        out[k] = np.asarray(w, np.float32)
    return out


def flat(tree, prefix="", out=None):
    """A nested dict of arrays → {"a/b/c": numpy array}."""
    out = {} if out is None else out
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat(v, name, out)
        else:
            out[name] = np.asarray(v)
    return out


# The VAE of tests/test_quant_task_ab.py: its 256-channel stage passes the
# int8 shape gate (the tiny VAE's 32/64 channels never do).
GATED_VAE = dict(block_out_channels=(64, 256), layers_per_block=1, norm_num_groups=32)
GATED_VAE_SITES = 14  # its (256, 256) convs: encoder 5, decoder 9


def quant_transform_world(modes, calibrate: bool = False) -> dict:
    """The one-step transform at the tiny UNet with the GATED_VAE, the same
    weights and 64² image in both packages (f32), under each of ``modes``:
    ``{"out": {mode: (jax, port)}}`` as numpy. With ``calibrate``, also both
    packages' ``calibrate_static_scales`` (``"jscales"``, ``"tscales"``);
    ``"int8_static"`` then runs on the JAX package's scales in both."""
    import torch

    from ldiffusion_tpu.diffusion import pipeline as jpipe
    from ldiffusion_tpu.ops import quant as jq
    from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
    from ldiffusion_tpu_torch.models.vae import VAEConfig as TVAEConfig
    from ldiffusion_tpu_torch.ops import quant as tq

    comps = tpipe.SDComponents.random(seed=3, device="cpu", vae_config=TVAEConfig(**GATED_VAE))
    jc = jax_components_of(comps)
    img = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():  # the embedding's parity is test_torch_port_pipeline's
        emb = tpipe.trajectory_text_emb(comps, 1)
    jemb = jnp.asarray(emb.numpy())

    def jax_fn(params, x):
        return jpipe.one_step_transform(jc, params, x, jemb)

    def port_fn(x):
        return tpipe.one_step_transform(comps, x, emb)

    world = {"out": {}}
    if calibrate:
        world["jscales"] = jq.calibrate_static_scales(lambda x: jax_fn(jc.params, x),
                                                      jnp.asarray(img))
        world["tscales"] = tq.calibrate_static_scales(port_fn, torch.from_numpy(img))
    try:
        for mode in modes:
            for m in (jq, tq):
                m.set_quant_mode(mode)
                m.set_static_amax(world.get("jscales"))
            # a fresh function per mode: jax.jit caches by function, and the
            # mode changes the traced program
            ref = jax.jit(lambda p, x: jax_fn(p, x))(jc.params, jnp.asarray(img))
            with torch.no_grad():
                got = port_fn(torch.from_numpy(img))
            world["out"][mode] = (np.asarray(ref), got.numpy())
    finally:
        for m in (jq, tq):
            m.set_quant_mode("none")
            m.set_static_amax(None)
    return world
