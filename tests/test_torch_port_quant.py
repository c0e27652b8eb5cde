"""The port's int8 W8A8 modes (``ldiffusion_tpu_torch/ops/quant.py``, the
``QConv`` / ``QDense`` layers) against the JAX package's
(``ldiffusion_tpu/ops/quant.py``) on the same f32 inputs.

Op level: the int8 codes, the scales and the int32 accumulators are
bit-equal; the f32 outputs agree within 1e-6 of their scale (the same
epilogue, ``acc * (sx * sw) + bias``, where XLA may contract the product and
the sum into one FMA). Block level: f32 both sides, and a code flips where
the two packages' activations straddle a rounding edge (see BLOCK_MEAN_TOL).
The site lists (gated call sites) of the
one-step transform at SD-v1.5 width and of bench.py's program are the JAX
package's. The whole transform under each mode is
``test_torch_port_quant_transform.py``; calibration,
``test_torch_port_quant_static.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from ldiffusion_tpu.models.unet import UNet2DCondition as JUNet
from ldiffusion_tpu.models.unet import UNet2DConditionConfig as JUNetConfig
from ldiffusion_tpu.models.vae import AutoencoderKL as JVAE
from ldiffusion_tpu.models.vae import VAEConfig as JVAEConfig
from ldiffusion_tpu.ops import quant as jq
from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
from ldiffusion_tpu_torch.diffusion.schedulers import PNDMScheduler
from ldiffusion_tpu_torch.models.layers import Downsample, QConv, QDense
from ldiffusion_tpu_torch.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ldiffusion_tpu_torch.ops import quant as tq
from torch_port_common import GATED_VAE, GATED_VAE_SITES, jax_components_of, jax_laplace_noise
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

OP_RTOL = 1e-6    # of the output's largest magnitude
NONE_TOL = 1e-5   # a block in f32, summation order only
# A quantized block: its quantized layers take activations that differ by
# ~1e-6 between the packages (f32 summation order); where one sits at a
# rounding edge of x / scale its code flips, one quantization step (amax /
# 127) at that element, and a later quantizer can flip more from there (a
# chain under "int8_all", through the attention's softmax). The port's own
# output moves as much under a 1e-6 perturbation of its input. Few elements
# move: the mean error stays under BLOCK_MEAN_TOL, the largest under
# BLOCK_MAX_TOL of the output's scale; each mode moves the mean by more.
BLOCK_MEAN_TOL = 1e-3
BLOCK_MAX_TOL = 0.03


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    for m in (jq, tq):
        m.set_quant_mode("none")
        m.set_static_amax(None)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _assert_codes(jres, tres, nhwc=True):
    (jcode, jscale), (tcode, tscale) = jres, tres
    got = _nhwc(tcode) if nhwc and tcode.dim() == 4 else tcode.numpy()
    np.testing.assert_array_equal(got, np.asarray(jcode))
    np.testing.assert_array_equal(tscale.numpy().ravel(), np.asarray(jscale).ravel())


def _draw(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["conv_weight", "matmul_weight", "per_tensor"])
def test_sym_quant_codes_and_scales_bit_equal(case):
    rng = np.random.default_rng(0)
    if case == "conv_weight":  # HWIO per Cout ↔ OIHW per O
        k = _draw(rng, (3, 3, 24, 40), 0.1)
        jres = jq._sym_quant(jnp.asarray(k), axes=(0, 1, 2))
        tcode, tscale = tq._sym_quant(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                      dims=(1, 2, 3))
        np.testing.assert_array_equal(tcode.numpy().transpose(2, 3, 1, 0),
                                      np.asarray(jres[0]))
        np.testing.assert_array_equal(tscale.numpy().ravel(), np.asarray(jres[1]).ravel())
    elif case == "matmul_weight":  # (K, N) per column ↔ nn.Linear (N, K) per row
        w = _draw(rng, (48, 40), 0.2)
        jres = jq._sym_quant(jnp.asarray(w), axes=(0,))
        tcode, tscale = tq._sym_quant(torch.from_numpy(w.T.copy()), dims=(1,))
        np.testing.assert_array_equal(tcode.numpy().T, np.asarray(jres[0]))
        np.testing.assert_array_equal(tscale.numpy().ravel(), np.asarray(jres[1]).ravel())
    else:
        x = _draw(rng, (2, 7, 5, 48), 3.0)
        _assert_codes(jq._sym_quant(jnp.asarray(x), axes=(0, 1, 2, 3)),
                      tq._sym_quant(_nchw(x), dims=(0, 1, 2, 3)))


@pytest.mark.parametrize("branch", ["dynamic_small", "dynamic_subsampled", "record", "static"])
def test_act_quant_branches_bit_equal(branch):
    rng = np.random.default_rng(1)
    # H, W below 16 take the full amax; at/above 16 the ::4 view (NHWC dims 1, 2)
    shape = (2, 12, 20, 8) if branch == "dynamic_small" else (2, 16, 24, 8)
    x = _draw(rng, shape, 2.5)
    x[0, 1, 2, 3] = 40.0  # off the ::4 grid: the subsampled amax misses it and clips
    site = None
    if branch == "record":
        site = "down_0_resnet_0/conv1"
        for m in (jq, tq):
            m.set_quant_mode("int8_record")
    elif branch == "static":
        site = "mid_resnet_0/conv2"
        for m in (jq, tq):
            m.set_quant_mode("int8_static")
            m.set_static_amax({site: 7.3})
    _assert_codes(jq._act_quant(jnp.asarray(x), site), tq._act_quant(_nchw(x), site))
    if branch == "record":
        assert float(tq._RECORDED[site]) == float(jq._RECORDED[site]) == 40.0


# ---------------------------------------------------------------------------
# int8_conv / int8_matmul
# ---------------------------------------------------------------------------

CONV_CASES = {
    "3x3_pad1": dict(x=(2, 18, 20, 32), k=(3, 3, 32, 48), stride=(1, 1), pad=((1, 1), (1, 1))),
    "1x1": dict(x=(2, 16, 16, 40), k=(1, 1, 40, 24), stride=(1, 1), pad=((0, 0), (0, 0))),
    "3x3_stride2_pad01": dict(x=(1, 16, 18, 24), k=(3, 3, 24, 32), stride=(2, 2),
                              pad=((0, 1), (0, 1))),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_int8_conv_matches_jax(name):
    c = CONV_CASES[name]
    rng = np.random.default_rng(2)
    x, k, b = _draw(rng, c["x"]), _draw(rng, c["k"], 0.1), _draw(rng, c["k"][-1:], 0.5)
    xt, wt = _nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    jx, jw = jq._act_quant(jnp.asarray(x)), jq._sym_quant(jnp.asarray(k), axes=(0, 1, 2))
    tx, tw = tq._act_quant(xt), tq._sym_quant(wt, dims=(1, 2, 3))
    _assert_codes(jx, tx)
    np.testing.assert_array_equal(tw[0].numpy().transpose(2, 3, 1, 0), np.asarray(jw[0]))
    jacc = jax.lax.conv_general_dilated(jx[0], jw[0], c["stride"], list(c["pad"]),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    tacc = tq.int8_conv_acc(tx[0], tw[0], c["stride"], c["pad"])
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(tacc), np.asarray(jacc))
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(k), c["stride"], c["pad"],
                                  jnp.asarray(b), out_dtype=jnp.float32))
    got = _nhwc(tq.int8_conv(xt, wt, c["stride"], c["pad"], torch.from_numpy(b),
                             out_dtype=torch.float32))
    assert np.abs(got - ref).max() <= OP_RTOL * np.abs(ref).max()


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(3)
    x, w, b = _draw(rng, (3, 10, 48), 2.0), _draw(rng, (48, 40), 0.2), _draw(rng, (40,))
    wt = torch.from_numpy(w.T.copy())
    jx, jw = jq._sym_quant(jnp.asarray(x), axes=(0, 1, 2)), jq._sym_quant(jnp.asarray(w),
                                                                         axes=(0,))
    tx, tw = tq._sym_quant(torch.from_numpy(x), dims=(0, 1, 2)), tq._sym_quant(wt, dims=(1,))
    _assert_codes(jx, tx, nhwc=False)
    jacc = jax.lax.dot_general(jx[0], jw[0], (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = tq.int_mm(tx[0].reshape(-1, 48), tw[0].t())
    np.testing.assert_array_equal(tacc.reshape(3, 10, 40).numpy(), np.asarray(jacc))
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    out_dtype=jnp.float32))
    got = tq.int8_matmul(torch.from_numpy(x), wt, torch.from_numpy(b),
                         out_dtype=torch.float32).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= OP_RTOL * np.abs(ref).max()


def test_conv_shape_gate_matches_jax():
    widths = (3, 4, 32, 64, 128, 192, 255, 256, 257, 320, 383, 384, 512, 640, 960, 1280, 2560)
    for cin in widths:
        for cout in widths:
            assert tq.conv_shape_gate(cin, cout) == jq.conv_shape_gate(cin, cout), (cin, cout)


def test_int_mm_pads_odd_shapes_exactly():
    """Shapes outside CUDA's rules (M ≤ 16, K or N not multiples of 8) go
    through the zero-padded product; on the CPU it must equal the direct one."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 13), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (7, 13), dtype=np.int8)).t()
    exact = a.long() @ b.long()
    padded_a = tq._pad_to(tq._pad_to(a, 0, 1, minimum=17), 1, 8)
    padded_b = tq._pad_to(tq._pad_to(b.t(), 0, 8), 1, 8).t()
    np.testing.assert_array_equal(torch._int_mm(padded_a, padded_b)[:5, :7].numpy(),
                                  exact.numpy())
    np.testing.assert_array_equal(tq.int_mm(a, b).numpy(), exact.numpy())


# What quantizing a bf16 copy of a weight would do: the JAX QConv quantizes
# its f32 param (param_dtype f32) and computes in bf16, so the port's QConv
# takes its codes from the f32 weight before a cast down (models/layers.py,
# Int8Weight; test_bf16_held_qconv_quantizes_its_f32_weight_as_jax). At an
# SD-v1.5 conv (320 → 320, 3×3, N(0, 1/fan_in) weights) bf16's rounding (at
# most 2^-8 relative) would move every scale by at most that much and a code
# by at most one step; BF16_HELD_CODE_SHARE bounds the share of codes it moves
# (measured: 0.0584, every one of the 320 scales apart, by up to 0.0038).
BF16_HELD_CODE_SHARE = 0.1


def test_bf16_held_weight_quantizes_apart_from_jax_f32_param():
    w = _draw(np.random.default_rng(12), (3, 3, 320, 320), 1 / np.sqrt(2880))  # HWIO
    jcode, jscale = jq._sym_quant(jnp.asarray(w), axes=(0, 1, 2))
    conv = QConv(320, 320, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    conv.to(torch.bfloat16)
    tcode, tscale = tq._sym_quant(conv.weight.detach(), dims=(1, 2, 3))
    tcode = tcode.permute(2, 3, 1, 0).numpy().astype(np.int32)
    step = tcode - np.asarray(jcode).astype(np.int32)
    rel = np.abs(tscale.numpy().ravel() / np.asarray(jscale).ravel() - 1)
    share = float(np.mean(step != 0))
    assert np.abs(step).max() == 1
    assert 0 < rel.min() and rel.max() <= 2.0 ** -8
    assert 0 < share <= BF16_HELD_CODE_SHARE, share


# A bf16-held QConv's int8 output against the JAX bf16 QConv on the same
# codes: the f32 epilogue may differ by the FMA contraction, and a value at a
# bf16 rounding edge then rounds one bf16 step apart, 2^-8 of its magnitude.
BF16_OUT_RTOL = 2.0 ** -8


def _flax_node(tree, site):
    for key in site.split("/"):
        tree = tree[key]
    return tree


def test_bf16_held_qconv_quantizes_its_f32_weight_as_jax():
    """SD components from f32 flax weights, cast to bf16 by ``from_flax``
    (through ``SDComponents.to``): under "int8" every gated QConv uses the
    codes and scales of its f32 weight, bit-equal to the JAX QConv's, and its
    output is the JAX bf16 QConv's. A bf16 weight changed after the cast
    raises; an f32 module changed after quantizing quantizes again."""
    from ldiffusion_tpu.models.layers import QConv as JQConv

    port = tpipe.SDComponents.random(seed=3, device="cpu", vae_config=VAEConfig(**GATED_VAE))
    flax = jax_components_of(port).params
    comps = tpipe.SDComponents.from_flax(flax, port.unet_config, port.vae_config,
                                         port.text_config, dtype=torch.bfloat16, device="cpu")
    gated = [m for m in comps.vae.modules()
             if isinstance(m, QConv) and tq.conv_shape_gate(m.in_channels, m.out_channels)]
    assert len(gated) == GATED_VAE_SITES
    tq.set_quant_mode("int8")
    jq.set_quant_mode("int8")
    for m in gated:
        assert m.weight.dtype == torch.bfloat16
        node = _flax_node(flax["vae"], m.site)
        (code, scale), bias = m.int8_weight()
        _assert_codes(jq._sym_quant(jnp.asarray(node["kernel"]), axes=(0, 1, 2)),
                      (code.permute(2, 3, 1, 0), scale), nhwc=False)
        np.testing.assert_array_equal(bias.numpy(), np.asarray(node["bias"]))
    m = gated[0]
    x = _draw(np.random.default_rng(13), (1, 8, 8, m.in_channels))
    xb = jnp.asarray(x, jnp.bfloat16)
    (ph, _), (sh, sw) = m.padding, m.stride
    ref = JQConv(m.out_channels, m.kernel_size, (sh, sw), ph, dtype=jnp.bfloat16).apply(
        {"params": _flax_node(flax["vae"], m.site)}, xb)
    before = tq.int8_conv.launches
    with torch.no_grad():
        got = m(_nchw(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert tq.int8_conv.launches - before == 1 and got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(_nhwc(got.float()) - ref).max() <= BF16_OUT_RTOL * np.abs(ref).max()

    with torch.no_grad():  # a stale bf16 weight never quantizes silently
        m.weight.mul_(2)
        with pytest.raises(RuntimeError, match="f32 weights"):
            m(torch.zeros(1, m.in_channels, 8, 8, dtype=torch.bfloat16))
    f32 = QConv(256, 256, 3, padding=1)
    with torch.no_grad():
        f32(torch.randn(1, 256, 8, 8))
        codes = f32.int8_weight()[0][0].clone()
        f32.weight.mul_(-1)  # an f32 weight changed in place quantizes again
        f32(torch.randn(1, 256, 8, 8))
    assert torch.equal(f32.int8_weight()[0][0], -codes)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def test_none_mode_is_the_plain_forward_bit_for_bit():
    torch.manual_seed(0)
    x = torch.randn(2, 16, 9, 11)
    q = QConv(16, 24, 3, padding=1)
    plain = torch.nn.Conv2d(16, 24, 3, padding=1)
    plain.load_state_dict(q.state_dict())
    assert list(q.state_dict()) == ["weight", "bias"]
    assert torch.equal(q(x), plain(x))
    down = Downsample(16, asymmetric_pad=True)
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)),
                                     down.conv.weight, down.conv.bias, stride=2)
    assert torch.equal(down(x), ref)
    d = QDense(16, 8)
    lin = torch.nn.Linear(16, 8)
    lin.load_state_dict(d.state_dict())
    assert torch.equal(d(x.permute(0, 2, 3, 1)), lin(x.permute(0, 2, 3, 1)))


@pytest.mark.parametrize("mode,cin,quantized", [
    ("int8", 256, True), ("int8", 128, False), ("int8_static", 384, True),
    ("int8_all", 32, True), ("none", 512, False)])
def test_qconv_gating(mode, cin, quantized):
    tq.set_quant_mode(mode)
    conv = QConv(cin, cin, 1)
    conv.site = "some/site"
    before = tq.int8_conv.launches
    with torch.no_grad():
        conv(torch.randn(1, cin, 4, 4))
    assert (tq.int8_conv.launches - before == 1) == quantized


def test_qdense_quantizes_only_under_int8_all():
    dense = QDense(32, 16)
    for mode, quantized in (("int8", False), ("int8_static", False), ("int8_all", True)):
        tq.set_quant_mode(mode)
        before = tq.int8_matmul.launches
        with torch.no_grad():
            dense(torch.randn(2, 5, 32))
        assert (tq.int8_matmul.launches - before == 1) == quantized


def test_quantized_forward_refuses_grad():
    tq.set_quant_mode("int8")
    conv = QConv(256, 256, 3, padding=1)
    conv.site = "x"
    with pytest.raises(RuntimeError, match="int8_conv"):
        conv(torch.randn(1, 256, 4, 4))
    tq.set_quant_mode("int8_all")
    with pytest.raises(RuntimeError, match="int8_matmul"):
        QDense(8, 8)(torch.randn(2, 8))
    with torch.no_grad():  # inference is fine
        assert conv(torch.randn(1, 256, 4, 4)).shape == (1, 256, 4, 4)


def test_controlnet_shares_the_unets_site_keys():
    from ldiffusion_tpu_torch.models.controlnet import ControlNet

    cfg = UNet2DConditionConfig.tiny()
    with torch.device("meta"):
        unet, cn = UNet2DCondition(cfg), ControlNet(cfg, conditioning_embed_channels=(8, 16))

    def sites(m):
        return {n: q.site for n, q in m.named_modules() if isinstance(q, QConv)}

    u, c = sites(unet), sites(cn)
    assert None not in u.values() and None not in c.values()
    shared = set(u) & set(c)
    assert shared and set(c) == shared  # every ControlNet QConv is an encoder layer
    assert all(u[n] == c[n] for n in shared)


# ---------------------------------------------------------------------------
# the one-step transform, calibration and the site lists
# ---------------------------------------------------------------------------

def _block_pair(kind):
    """A flax block and the port's on its weights, with inputs: a ResnetBlock
    128 → 256 (conv1 and the shortcut ungated, conv2 gated) or a
    Transformer2D at 256 channels (proj_in / proj_out gated; its QDenses
    quantize under "int8_all"). Site keys: the names inside the block."""
    from torch import nn

    from ldiffusion_tpu.models import layers as jl
    from ldiffusion_tpu_torch.models import convert
    from ldiffusion_tpu_torch.models import layers as tl

    rng = np.random.default_rng(6)
    rows = []
    if kind == "resnet":
        jm, tm = jl.ResnetBlock(256, groups=32), tl.ResnetBlock(128, 256, temb_channels=64)
        args = (_draw(rng, (2, 16, 16, 128)), _draw(rng, (2, 64)))
        convert._resnet(rows, "blk", "blk", True, True)
    else:
        jm, tm = jl.Transformer2D(4, 64, groups=32), tl.Transformer2D(256, 4, 64, 32)
        args = (_draw(rng, (2, 8, 8, 256)), _draw(rng, (2, 5, 32)))
        convert._transformer2d(rows, "blk", "blk")
    params = jax.jit(lambda *a: jm.init(jax.random.key(0), *a))(*args)["params"]
    holder = nn.Module()
    holder.blk = tm
    holder.load_state_dict(convert.from_flax(rows, {"blk": params}))
    for name, m in tm.named_modules():
        if isinstance(m, QConv):
            m.site = name.replace(".", "/")
    targs = (_nchw(args[0]), torch.from_numpy(args[1]))
    return (lambda p, *a: jm.apply({"params": p}, *a)), params, args, tm.eval(), targs


@pytest.mark.parametrize("kind", ["resnet", "transformer2d"])
def test_blocks_under_each_mode_match_jax(kind):
    japply, params, args, tm, targs = _block_pair(kind)
    scales = jq.calibrate_static_scales(lambda *a: japply(params, *a), *args)
    assert sorted(scales) == (["conv2"] if kind == "resnet" else ["proj_in", "proj_out"])
    out = {}
    for mode in ("none", "int8", "int8_all", "int8_static"):
        for m in (jq, tq):
            m.set_quant_mode(mode)
            m.set_static_amax(scales)
        # a fresh function per mode: jax.jit caches by function, and the mode
        # changes the traced program
        ref = np.asarray(jax.jit(lambda p, *a: japply(p, *a))(params, *args))
        with torch.no_grad():
            got = _nhwc(tm(*targs))
        out[mode] = ref
        err = np.abs(got - ref)
        if mode == "none":
            assert float(err.max()) < NONE_TOL
        else:
            assert float(err.mean()) < BLOCK_MEAN_TOL, (mode, float(err.mean()))
            assert float(err.max()) < BLOCK_MAX_TOL * np.abs(ref).max(), (mode, float(err.max()))
            assert float(np.abs(ref - out["none"]).mean()) > 5 * BLOCK_MEAN_TOL, mode


def test_calibration_restores_the_mode_when_fn_raises():
    tq.set_quant_mode("int8")

    def boom():
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        tq.calibrate_static_scales(boom)
    assert tq.quant_mode() == "int8" and not tq._RECORDED
    with pytest.raises(ValueError, match="boom"):
        tq.record_quant_sites(boom)
    assert tq.quant_mode() == "int8"


def test_sd15_one_step_sites_match_jax():
    """114 gated sites at SD-v1.5 width (512², 77 tokens): JAX through
    jax.eval_shape, the port on fake CPU tensors (nothing computed)."""
    size = 512
    junet, jvae = JUNet(JUNetConfig.sd15()), JVAE(JVAEConfig.sd15())
    key = jax.random.key(0)
    uparams = jax.eval_shape(junet.init, key, jnp.zeros((1, size // 8, size // 8, 4)),
                             jnp.int32(1), jnp.zeros((1, 77, 768)))["params"]
    vparams = jax.eval_shape(jvae.init, key, jnp.zeros((1, size, size, 3)))["params"]
    jc = jpipe.SDComponents(unet_config=JUNetConfig.sd15(), vae_config=JVAEConfig.sd15(),
                            text_config=JCLIPConfig.sd15(), unet=junet, vae=jvae, text=None,
                            params={})
    jsites = jq.record_quant_sites(
        lambda p, x, e: jpipe.one_step_transform(jc, p, x, e), {"unet": uparams, "vae": vparams},
        jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 77, 768), jnp.float32))

    with FakeTensorMode():
        comps = dataclasses.make_dataclass("Comps", ["unet", "vae", "scheduler"])(
            UNet2DCondition(UNet2DConditionConfig.sd15()), AutoencoderKL(VAEConfig.sd15()),
            PNDMScheduler())
        tsites = tq.record_quant_sites(
            lambda x, e: tpipe.one_step_transform(comps, x, e),
            torch.empty(1, size, size, 3), torch.empty(1, 77, 768))
    assert tsites == jsites
    assert len(tsites) == 114
    assert sum(s.startswith("encoder/") for s in tsites) == 18
    assert sum(s.startswith("decoder/") for s in tsites) == 26


def test_bench_loop_sites_match_jax():
    """bench.py's program (encode → 5 PNDM steps with Laplace noise → decode,
    ``bench.py:88-106``, written out here with the JAX package's pieces) and
    the port's ``laplace_reverse_transform`` hit the same gated sites."""
    comps = tpipe.SDComponents.random(seed=3, device="cpu", vae_config=VAEConfig(**GATED_VAE))
    jc = jax_components_of(comps)
    sch = jc.scheduler
    ts = sch.set_timesteps(5)
    t_values = jnp.asarray(ts.array)
    scales = jnp.sqrt(1.0 - jnp.asarray(sch.schedule.alphas_cumprod)[ts.array])

    def pipeline(params, images, key):
        emb = jpipe.trajectory_text_emb(jc, params, images.shape[0])
        latents = jc.vae.apply({"params": params["vae"]}, images, method=jc.vae.encode_mean)
        state = sch.init_state(latents.shape, latents.dtype)

        def body(carry, inp):
            lat, st = carry
            t, scale, k = inp
            noise = jax.random.laplace(k, lat.shape, lat.dtype) * scale.astype(lat.dtype)
            eps = jc.unet.apply({"params": params["unet"]}, lat + noise, t, emb)
            return sch.step(ts, st, eps, t, lat), None

        keys = jax.random.split(key, len(ts))
        (latents, _), _ = jax.lax.scan(body, (latents, state), (t_values, scales, keys))
        return jc.vae.apply({"params": params["vae"]}, latents, method=jc.vae.decode_latents)

    jsites = jq.record_quant_sites(pipeline, jc.params,
                                   jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.float32),
                                   jax.random.key(0))
    noise = jax_laplace_noise(jax.random.key(1), len(ts.values), (2, 32, 32, 4))
    tsites = tq.record_quant_sites(
        lambda x: tpipe.laplace_reverse_transform(comps, x, 5, noise=noise),
        torch.zeros(2, 64, 64, 3))
    assert tsites == jsites and len(tsites) == GATED_VAE_SITES
