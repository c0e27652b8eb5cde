"""The ControlNet, the UNet's residual hooks, ``encode_sample`` and the
depth-conditioned ``multimodal_augment`` of the port against the JAX
package's, on the CPU at the tiny configs in f32, from the same weights.

Every ControlNet parameter is drawn non-zero from a numpy seed: a fresh
flax init zeroes the zero convolutions and ``cond_out``, and would make
every residual 0 and any comparison vacuous. The tiny VAE halves the image
(64² → 32² latents), so the tiny ControlNet's conditioning embedding has
two stages, (8, 16), one stride-2 convolution. The draws (the encode's
normal, the Laplace noise) are the JAX package's, from ``split(key)``.

Tolerances: 1e-4 absolute for the UNet with residuals, ``encode_sample``
and ``multimodal_augment`` (f32 both sides, another summation order
through a few tiny layers; the tiny UNet alone agrees to ~3e-6); the
ControlNet's residuals within 1e-4 of each one's largest magnitude (random
weights everywhere make them O(10)).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.diffusion import multimodal as jmm
from ldiffusion_tpu.models.controlnet import ControlNet as JControlNet
from ldiffusion_tpu.models.unet import UNet2DConditionConfig as JUNetCfg
from ldiffusion_tpu_torch.diffusion import multimodal as tmm
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
from ldiffusion_tpu_torch.models import controlnet as tcn
from ldiffusion_tpu_torch.models.controlnet import ControlNet
from ldiffusion_tpu_torch.models.convert import (
    _LEAVES,
    _torch_layout,
    controlnet_from_flax,
    controlnet_rows,
    controlnet_to_flax,
)
from ldiffusion_tpu_torch.models.layers import Transformer2D
from ldiffusion_tpu_torch.models.unet import UNet2DConditionConfig
from torch_port_common import JittedModule, flat, jax_components_of, jitted, random_params
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

TOL = 1e-4
EMBED = (8, 16)
B = 2


@pytest.fixture(scope="module")
def world():
    comps = SDComponents.random(device="cpu")
    jc = jitted(jax_components_of(comps))
    jnet = JControlNet(JUNetCfg.tiny(), conditioning_embed_channels=EMBED)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.zeros((1, 32, 32, 4)), 1,
                            jnp.zeros((1, 5, 32)), jnp.zeros((1, 64, 64, 3)))["params"]
    cn_params = random_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                              np.random.default_rng(7))
    cn = ControlNet(UNet2DConditionConfig.tiny(), conditioning_embed_channels=EMBED)
    cn.load_state_dict(controlnet_from_flax(cn_params, cn.config, EMBED))
    rng = np.random.default_rng(0)
    return {"jc": jc, "jnet": JittedModule(jnet), "cn_params": cn_params, "comps": comps,
            "cn": cn.eval(),
            "latents": rng.normal(size=(B, 32, 32, 4)).astype(np.float32),
            "ctx": rng.normal(size=(B, 6, 32)).astype(np.float32),
            "cond": rng.random((B, 64, 64, 3)).astype(np.float32),
            "rgb": rng.random((B, 64, 64, 3)).astype(np.float32),
            "dtm": rng.random((B, 64, 64, 1)).astype(np.float32)}


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _jax_residuals(world, t=501):
    return world["jnet"].apply({"params": world["cn_params"]}, world["latents"], jnp.int32(t),
                               world["ctx"], world["cond"])


def _port_residuals(world, cn=None, t=501, scale=1.0):
    with torch.no_grad():
        return (cn or world["cn"])(_nchw(world["latents"]), t, torch.from_numpy(world["ctx"]),
                                   _nchw(world["cond"]), conditioning_scale=scale)


def _residual_errors(port, ref):
    (pdown, pmid), (jdown, jmid) = port, ref
    assert len(pdown) == len(jdown) == 1 + 2 * 1 + 1  # conv_in, 2 layers, 1 downsample
    errs = []
    for p, j in list(zip(pdown, jdown)) + [(pmid, jmid)]:
        j = np.asarray(j)
        errs.append(float(np.abs(_nhwc(p) - j).max()) / max(1.0, float(np.abs(j).max())))
    return errs


def test_controlnet_residuals_match_jax(world):
    ref = _jax_residuals(world)
    assert min(float(np.abs(np.asarray(r)).max()) for r in ref[0]) > 0.1  # not vacuous
    assert max(_residual_errors(_port_residuals(world), ref)) <= TOL
    # conditioning_scale multiplies every residual
    half = _port_residuals(world, scale=0.5)
    full = _port_residuals(world)
    for h, f in zip(half[0] + (half[1],), full[0] + (full[1],)):
        torch.testing.assert_close(h, 0.5 * f)


def test_controlnet_attention_norm_takes_32_groups_not_norm_num_groups(world, monkeypatch):
    """The JAX ControlNet builds its Transformer2D with the default 32 groups
    (``ldiffusion_tpu/models/controlnet.py:83-84, 95``), where the UNet takes
    ``norm_num_groups`` (8 at the tiny config). A port built with the UNet's
    groups is off by far more than the tolerance."""
    groups = [m.norm.groups for m in world["cn"].modules() if isinstance(m, Transformer2D)]
    assert groups == [32, 32]
    assert {m.norm.groups for m in world["comps"].unet.modules()
            if isinstance(m, Transformer2D)} == {8}
    monkeypatch.setattr(tcn, "ATTN_GROUPS", UNet2DConditionConfig.tiny().norm_num_groups)
    wrong = ControlNet(UNet2DConditionConfig.tiny(), conditioning_embed_channels=EMBED)
    wrong.load_state_dict(world["cn"].state_dict())
    errs = _residual_errors(_port_residuals(world, wrong.eval()), _jax_residuals(world))
    assert max(errs) > 100 * TOL


def test_unet_with_residuals_matches_jax(world):
    jdown, jmid = _jax_residuals(world)
    jc = world["jc"]
    ref = np.asarray(jc.unet.apply({"params": jc.params["unet"]}, world["latents"], jnp.int32(501),
                                   world["ctx"], down_block_residuals=jdown, mid_residual=jmid))
    plain = np.asarray(jc.unet.apply({"params": jc.params["unet"]}, world["latents"],
                                     jnp.int32(501), world["ctx"]))
    with torch.no_grad():
        out = world["comps"].unet(_nchw(world["latents"]), 501, torch.from_numpy(world["ctx"]),
                                  down_block_residuals=[_nchw(np.asarray(r)) for r in jdown],
                                  mid_residual=_nchw(np.asarray(jmid)))
    assert float(np.abs(ref - plain).max()) > 0.1  # the residuals move the output
    assert float(np.abs(_nhwc(out) - ref).max()) <= TOL


def test_encode_sample_on_the_jax_draw(world):
    jc, x = world["jc"], world["rgb"] * 2.0 - 1.0
    key = jax.random.key(11)
    ref = np.asarray(jc.vae.apply({"params": jc.params["vae"]}, x, rng=key,
                                  method=jc.vae.encode_sample))
    eps = np.array(jax.random.normal(key, ref.shape, jnp.float32))
    with torch.no_grad():
        out = world["comps"].vae.encode_sample(_nchw(x), noise=_nchw(eps))
        mean = world["comps"].vae.encode_mean(_nchw(x))
    assert float(np.abs(_nhwc(out) - ref).max()) <= TOL
    assert float((out - mean).abs().max()) > 1e-2  # the draw is not the mean


def test_multimodal_augment_matches_jax(world):
    jc, key = world["jc"], jax.random.key(5)
    ref = np.asarray(jmm.multimodal_augment(jc, world["jnet"], world["cn_params"], world["rgb"],
                                            world["dtm"], key))
    k_enc, k_noise = jax.random.split(key)
    shape = (B, 32, 32, 4)
    enc = torch.from_numpy(np.array(jax.random.normal(k_enc, shape, jnp.float32)))
    lap = torch.from_numpy(np.array(jax.random.laplace(k_noise, shape, jnp.float32)))
    with torch.no_grad():
        out = tmm.multimodal_augment(world["comps"], world["cn"], torch.from_numpy(world["rgb"]),
                                     torch.from_numpy(world["dtm"]), enc_noise=enc, noise=lap)
    assert out.shape == (B, 64, 64, 3) and out.dtype == torch.float32
    assert float(np.abs(out.numpy() - ref).max()) <= TOL
    assert tmm.DEFAULT_MM_PROMPT_IDS == jmm.DEFAULT_MM_PROMPT_IDS


def test_multimodal_augment_draws_from_one_generator(world):
    rgb, dtm = torch.from_numpy(world["rgb"]), torch.from_numpy(world["dtm"])
    with torch.no_grad():
        a, b = (tmm.multimodal_augment(world["comps"], world["cn"], rgb, dtm,
                                       generator=torch.Generator().manual_seed(s))
                for s in (0, 0))
        c = tmm.multimodal_augment(world["comps"], world["cn"], rgb, dtm,
                                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c) and bool(torch.isfinite(a).all())


def test_controlnet_weights_round_trip_bit_exact(world):
    sd = world["cn"].state_dict()
    back = controlnet_to_flax(sd, world["cn"].config, EMBED)
    want, got = flat(world["cn_params"]), flat(back)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    again = controlnet_from_flax(back, world["cn"].config, EMBED)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_full_width_controlnet_structure_matches_jax():
    """SD-v1.5 width, conditioning (16, 32, 96, 256): the port on
    ``device="meta"`` against ``jax.eval_shape`` of the flax init."""
    with torch.device("meta"):
        port = ControlNet(UNet2DConditionConfig.sd15())
    sd = port.state_dict()
    abstract = jax.eval_shape(JControlNet(JUNetCfg.sd15()).init, jax.random.key(0),
                              jnp.zeros((1, 8, 8, 4)), 1, jnp.zeros((1, 5, 768)),
                              jnp.zeros((1, 64, 64, 3)))["params"]
    jshapes = {"/".join(k.key for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    assert sum(p.numel() for p in port.parameters()) == \
        sum(math.prod(shape) for shape in jshapes.values())
    carried = set()
    for tp, fp, kind in controlnet_rows(UNet2DConditionConfig.sd15(), (16, 32, 96, 256)):
        tw, fw = _LEAVES[kind]
        want = _torch_layout(kind, np.zeros(jshapes[f"{fp}/{fw}"], np.float32)).shape
        assert tuple(sd[f"{tp}.{tw}"].shape) == want, fp
        carried.add(f"{tp}.{tw}")
        if f"{fp}/bias" in jshapes:
            assert tuple(sd[f"{tp}.bias"].shape) == jshapes[f"{fp}/bias"], fp
            carried.add(f"{tp}.bias")
    assert carried == set(sd)
    assert len(port.controlnet_down_blocks) == 12  # every skip of the SD-v1.5 UNet
