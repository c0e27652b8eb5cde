"""The port's models (``ldiffusion_tpu_torch/models``) against the JAX package's.

Each block of ``models/layers.py`` and the tiny CLIP, UNet, VAE and DynUNet run
in both packages on the same weights — the JAX module's initial parameters,
carried across with ``*_from_flax`` — and the same numpy inputs, at f32.
Tolerance: max abs 1e-3 (f32 convolutions and matmuls summed in another order
over a few layers; a wrong layout, eps or activation is off by ≫ 1e-2).
At the SD-v1.5 widths only structure is compared, for free: the port built on
``device="meta"`` against ``jax.eval_shape`` of the flax init.
"""
import math

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ldiffusion_tpu.models import layers as jl
from ldiffusion_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from ldiffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.models.dynunet import DynUNetConfig as JDynCfg
from ldiffusion_tpu.models.unet import UNet2DCondition as JUNet
from ldiffusion_tpu.models.unet import UNet2DConditionConfig as JUNetCfg
from ldiffusion_tpu.models.vae import AutoencoderKL as JVAE
from ldiffusion_tpu.models.vae import VAEConfig as JVAECfg
from ldiffusion_tpu_torch.models import convert
from ldiffusion_tpu_torch.models import layers as tl
from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ldiffusion_tpu_torch.models.dynunet import DynUNet, DynUNetConfig
from ldiffusion_tpu_torch.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

TOL = 1e-3
KEY = jax.random.key(0)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _carry(block: nn.Module, rows, params) -> nn.Module:
    """Load a flax block's params into the port block (rows prefixed 'blk')."""
    holder = nn.Module()
    holder.blk = block
    holder.load_state_dict(convert.from_flax(rows, {"blk": params}))
    return block.eval()


def _init_apply(module, *inputs, **kw):
    """flax init + apply, each jitted (one compile instead of op-by-op dispatch)."""
    params = jax.jit(lambda *a: module.init(KEY, *a, **kw))(*inputs)["params"]
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(params, *inputs)
    return params, np.asarray(out)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps,silu", [(1e-6, False), (1e-5, True)])
def test_fused_groupnorm_silu(eps, silu):
    x = _rand(0, 2, 4, 4, 64)
    jm = jl.FusedGroupNormSiLU(8, eps, silu)
    params = {"scale": _rand(1, 64), "bias": _rand(2, 64)}
    ref = jm.apply({"params": params}, jnp.asarray(x))
    port = _carry(tl.FusedGroupNormSiLU(64, 8, eps, silu), [("blk", "blk", "norm")], params)
    assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


def test_timestep_embedding():
    t = np.array([1, 500, 999], np.int64)
    ref = jl.timestep_embedding(jnp.asarray(t), 32)
    assert _max_diff(tl.timestep_embedding(torch.from_numpy(t), 32).numpy(), ref) < TOL


def test_time_embedding():
    emb = _rand(3, 2, 32)
    params, ref = _init_apply(jl.TimeEmbedding(128), jnp.asarray(emb))
    port = _carry(tl.TimeEmbedding(32, 128),
                  [(f"blk.{n}", f"blk/{n}", "linear") for n in ("linear_1", "linear_2")],
                  params)
    assert _max_diff(port(torch.from_numpy(emb)).detach().numpy(), ref) < TOL


@pytest.mark.parametrize("cin,cout,temb,eps", [(32, 64, 128, 1e-5),  # UNet: time + shortcut
                                               (32, 32, None, 1e-6)])  # VAE: neither
def test_resnet_block(cin, cout, temb, eps):
    x = _rand(4, 2, 8, 8, cin)
    t = _rand(5, 2, temb) if temb else None
    jm = jl.ResnetBlock(cout, eps=eps, groups=8, use_time_emb=temb is not None)
    inputs = (jnp.asarray(x),) + ((jnp.asarray(t),) if temb else ())
    params, ref = _init_apply(jm, *inputs)
    rows = []
    convert._resnet(rows, "blk", "blk", temb is not None, cin != cout)
    port = _carry(tl.ResnetBlock(cin, cout, eps, 8, temb), rows, params)
    out = port(_nchw(x), torch.from_numpy(t) if temb else None)
    assert _max_diff(_nhwc(out), ref) < TOL


@pytest.mark.parametrize("asymmetric", [False, True])
def test_downsample(asymmetric):
    x = _rand(6, 1, 9, 8, 16)
    params, ref = _init_apply(jl.Downsample(16, asymmetric_pad=asymmetric), jnp.asarray(x))
    port = _carry(tl.Downsample(16, asymmetric), [("blk.conv", "blk/conv", "conv")], params)
    assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


def test_upsample():
    x = _rand(7, 1, 4, 5, 16)
    params, ref = _init_apply(jl.Upsample(16), jnp.asarray(x))
    port = _carry(tl.Upsample(16), [("blk.conv", "blk/conv", "conv")], params)
    assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


def _attn_rows(prefix="blk", fprefix="blk"):
    return [(f"{prefix}.{p}", f"{fprefix}/{p}", "linear") for p in ("to_q", "to_k", "to_v")] + [
        (f"{prefix}.to_out.0", f"{fprefix}/to_out", "linear")]


@pytest.mark.parametrize("ctx_dim", [None, 24])
def test_attention(ctx_dim):
    x = _rand(8, 2, 10, 32)
    ctx = _rand(9, 2, 5, ctx_dim) if ctx_dim else None
    inputs = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if ctx_dim else ())
    params, ref = _init_apply(jl.Attention(2, 16), *inputs)
    port = _carry(tl.Attention(32, 2, 16, ctx_dim), _attn_rows(), params)
    out = port(torch.from_numpy(x), torch.from_numpy(ctx) if ctx_dim else None)
    assert _max_diff(out.detach().numpy(), ref) < TOL


def test_feed_forward():
    x = _rand(10, 2, 6, 32)
    params, ref = _init_apply(jl.FeedForward(32), jnp.asarray(x))
    port = _carry(tl.FeedForward(32), [("blk.net.0.proj", "blk/proj_in", "linear"),
                                       ("blk.net.2", "blk/proj_out", "linear")], params)
    assert _max_diff(port(torch.from_numpy(x)).detach().numpy(), ref) < TOL


def _transformer2d_rows():
    rows = []
    convert._transformer2d(rows, "blk", "blk")
    return rows


def test_transformer_block():
    x, ctx = _rand(11, 2, 16, 32), _rand(12, 2, 5, 24)
    params, ref = _init_apply(jl.TransformerBlock(2, 16), jnp.asarray(x), jnp.asarray(ctx))
    rows = [(tp.replace("blk.transformer_blocks.0", "blk"),
             fp.replace("blk/transformer_blocks_0", "blk"), kind)
            for tp, fp, kind in _transformer2d_rows() if "transformer_blocks" in tp]
    port = _carry(tl.TransformerBlock(32, 2, 16, 24), rows, params)
    out = port(torch.from_numpy(x), torch.from_numpy(ctx))
    assert _max_diff(out.detach().numpy(), ref) < TOL


def test_transformer2d():
    x, ctx = _rand(13, 2, 4, 4, 32), _rand(14, 2, 5, 24)
    params, ref = _init_apply(jl.Transformer2D(2, 16, groups=8), jnp.asarray(x),
                              jnp.asarray(ctx))
    port = _carry(tl.Transformer2D(32, 2, 16, 24, groups=8), _transformer2d_rows(), params)
    assert _max_diff(_nhwc(port(_nchw(x), torch.from_numpy(ctx))), ref) < TOL


def test_vae_attention():
    x = _rand(15, 1, 4, 4, 32)
    params, ref = _init_apply(jl.VAEAttention(32, groups=8), jnp.asarray(x))
    rows = []
    convert._vae_attn(rows, "blk", "blk")
    port = _carry(tl.VAEAttention(32, groups=8), rows, params)
    assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


def test_conv_transpose_layout():
    """flax ConvTranspose (SAME, transpose_kernel=False) ≙ torch ConvTranspose2d
    with the kernel flipped spatially (the DynUNet's upsampling)."""
    x = _rand(16, 1, 5, 6, 4)
    params, ref = _init_apply(fnn.ConvTranspose(8, (2, 2), strides=(2, 2)), jnp.asarray(x))
    port = _carry(nn.ConvTranspose2d(4, 8, 2, stride=2), [("blk", "blk", "convT")], params)
    assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------

def test_clip_text_tiny():
    ids = np.array([[1, 5, 9, 200, 2], [7, 3, 999, 0, 42]], np.int32)
    params, ref = _init_apply(JCLIP(JCLIPConfig.tiny()), jnp.asarray(ids))
    cfg = CLIPTextConfig.tiny()
    port = CLIPTextEncoder(cfg).eval()
    port.load_state_dict(convert.clip_text_from_flax(params, cfg.num_layers))
    out = port(torch.from_numpy(ids.astype(np.int64))).detach().numpy()
    assert _max_diff(out, ref) < TOL


def test_unet_tiny():
    x, ctx = _rand(17, 2, 8, 8, 4), _rand(18, 2, 5, 32)
    t = np.array([801, 3], np.int32)
    params, ref = _init_apply(JUNet(JUNetCfg.tiny()), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx))
    cfg = UNet2DConditionConfig.tiny()
    port = UNet2DCondition(cfg).eval()
    port.load_state_dict(convert.unet_from_flax(params, cfg))
    out = port(_nchw(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx))
    assert _max_diff(_nhwc(out), ref) < TOL


def test_vae_tiny():
    x, z = _rand(19, 1, 32, 32, 3), _rand(20, 1, 8, 8, 4)
    jm = JVAE(JVAECfg.tiny())
    params = jax.jit(lambda a: jm.init(KEY, a))(jnp.asarray(x))["params"]
    cfg = VAEConfig.tiny()
    port = AutoencoderKL(cfg).eval()
    port.load_state_dict(convert.vae_from_flax(params, cfg))
    with torch.no_grad():
        for method, inp in (("encode_mean", x), ("decode_latents", z)):
            ref = jax.jit(lambda p, a: jm.apply({"params": p}, a, method=getattr(jm, method)))(
                params, jnp.asarray(inp))
            out = getattr(port, method)(_nchw(inp))
            assert _max_diff(_nhwc(out), ref) < TOL, method


def test_dynunet_tiny():
    x = _rand(21, 2, 32, 32, 3)
    params, ref = _init_apply(JDynUNet(JDynCfg.tiny(), dtype=jnp.float32), jnp.asarray(x),
                              train=False)
    cfg = DynUNetConfig.tiny()
    port = DynUNet(cfg).eval()
    port.load_state_dict(convert.dynunet_from_flax(params, cfg))
    with torch.no_grad():
        assert _max_diff(_nhwc(port(_nchw(x))), ref) < TOL


_TINY = {
    "unet": (lambda: UNet2DCondition(UNet2DConditionConfig.tiny()),
             lambda sd: convert.unet_to_flax(sd, UNet2DConditionConfig.tiny()),
             lambda p: convert.unet_from_flax(p, UNet2DConditionConfig.tiny())),
    "vae": (lambda: AutoencoderKL(VAEConfig.tiny()),
            lambda sd: convert.vae_to_flax(sd, VAEConfig.tiny()),
            lambda p: convert.vae_from_flax(p, VAEConfig.tiny())),
    "clip": (lambda: CLIPTextEncoder(CLIPTextConfig.tiny()),
             lambda sd: convert.clip_text_to_flax(sd, 2),
             lambda p: convert.clip_text_from_flax(p, 2)),
    "dynunet": (lambda: DynUNet(DynUNetConfig.tiny()),
                lambda sd: convert.dynunet_to_flax(sd, DynUNetConfig.tiny()),
                lambda p: convert.dynunet_from_flax(p, DynUNetConfig.tiny())),
}


@pytest.mark.parametrize("name", sorted(_TINY))
def test_from_flax_to_flax_round_trip(name):
    build, to_flax, from_flax = _TINY[name]
    sd = tl.init_random_(build(), torch.Generator().manual_seed(1)).state_dict()
    back = from_flax(to_flax(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


# ---------------------------------------------------------------------------
# SD-v1.5 / 1024² plan widths: structure only, on device="meta"
# ---------------------------------------------------------------------------

def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_shapes(v, path) if isinstance(v, dict) else {path: tuple(v.shape)})
    return out


def _torch_shape(kind, s):
    if kind == "conv":
        return s[3], s[2], s[0], s[1]
    if kind == "convT":
        return s[2], s[3], s[0], s[1]
    return (s[1], s[0]) if kind == "linear" else s


_SD15 = {
    "unet": (lambda: UNet2DCondition(UNet2DConditionConfig.sd15()),
             lambda: JUNet(JUNetCfg.sd15()).init(KEY, jnp.zeros((1, 8, 8, 4)), jnp.int32(1),
                                                  jnp.zeros((1, 5, 768))),
             lambda: convert.unet_rows(UNet2DConditionConfig.sd15())),
    "vae": (lambda: AutoencoderKL(VAEConfig.sd15()),
            lambda: JVAE(JVAECfg.sd15()).init(KEY, jnp.zeros((1, 16, 16, 3))),
            lambda: convert.vae_rows(VAEConfig.sd15())),
    "clip": (lambda: CLIPTextEncoder(CLIPTextConfig.sd15()),
             lambda: JCLIP(JCLIPConfig.sd15()).init(KEY, jnp.zeros((1, 5), jnp.int32)),
             lambda: convert.clip_text_rows(12)),
    "dynunet_1024_plan": (lambda: DynUNet(DynUNetConfig()),
                          lambda: JDynUNet(JDynCfg()).init(KEY, jnp.zeros((1, 128, 128, 3))),
                          lambda: convert.dynunet_rows(DynUNetConfig())),
}


@pytest.mark.parametrize("name", sorted(_SD15))
def test_full_width_structure_matches_jax(name):
    build, jax_init, rows_fn = _SD15[name]
    with torch.device("meta"):
        port = build()
    sd = port.state_dict()
    jshapes = _flat_shapes(jax.eval_shape(jax_init)["params"])
    assert sum(p.numel() for p in port.parameters()) == \
        sum(math.prod(s) for s in jshapes.values())
    carried = {}
    for tp, fp, kind in rows_fn():
        tw, fw = convert._LEAVES[kind]
        carried[f"{fp}/{fw}"] = (f"{tp}.{tw}", kind)
        if f"{tp}.bias" in sd:
            carried[f"{fp}/bias"] = (f"{tp}.bias", "bias")
    assert set(carried) == set(jshapes)
    assert {tk for tk, _ in carried.values()} == set(sd)
    for fpath, (tkey, kind) in carried.items():
        assert tuple(sd[tkey].shape) == _torch_shape(kind, jshapes[fpath]), fpath
