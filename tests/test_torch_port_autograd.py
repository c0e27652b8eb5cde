"""Training-side attention and GroupNorm of the port on the CPU: the plain
versions of the flash forward with logsumexp (K5) and of the flash backward
(K6) against the JAX package's Pallas kernels in interpret mode, GroupNorm's
closed-form backward against autograd through the plain forward and the JAX
package's vjp, the ``autograd.Function``s under ``gradcheck`` in f64, and the
routing that keeps every gradient attached.

Tolerances are those of ``tests/test_flash_backward.py`` for the same shapes
(f32, (BH, S, D) = (2, 512, 64)): output 2e-5, logsumexp 2e-4 + 1e-5·|p|,
dq/dk/dv 2e-4 — the interpret-mode kernels sum in blocks, the plain versions
in one einsum. ``gradcheck`` runs at its defaults in f64. GroupNorm's backward
in f32 differs from autograd's and XLA's only in summation order: 1e-4 of
each gradient's largest magnitude; in bf16 its outputs may round one ulp
apart (2^-7 relative).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldiffusion_tpu.ops import groupnorm as jgn
from ldiffusion_tpu.ops.attention import _flash_attention_bhsd_lse, _flash_backward_bhsd
from ldiffusion_tpu_torch.models.layers import FusedGroupNormSiLU
from ldiffusion_tpu_torch.ops import attention as tatt
from ldiffusion_tpu_torch.ops import groupnorm as tgn
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

OUT_TOL = 2e-5
LSE_TOL = (2e-4, 1e-5)
GRAD_TOL = 2e-4


def _bhsd_inputs(seed, bh=2, s=512, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(4)]


def _port(x):
    """(BH, S, D) numpy → the port's (B, S, H, D) with B = BH, H = 1."""
    return torch.from_numpy(x)[:, :, None, :]


def test_plain_attention_lse_matches_pallas_k5_interpret():
    q, k, v, _ = _bhsd_inputs(0)
    out, lse = _flash_attention_bhsd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125,
                                         block_q=256, block_k=256, interpret=True)
    pout, plse = tatt.plain_attention_lse(_port(q), _port(k), _port(v), 0.125)
    np.testing.assert_allclose(pout[:, :, 0].numpy(), np.asarray(out), atol=OUT_TOL)
    np.testing.assert_allclose(plse[:, 0].numpy(), np.asarray(lse)[..., 0], atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])


def test_plain_attention_bwd_matches_pallas_k6_interpret():
    q, k, v, g = _bhsd_inputs(1)
    scale = 0.125
    out, lse = tatt.plain_attention_lse(_port(q), _port(k), _port(v), scale)
    delta = np.sum(g * out[:, :, 0].numpy(), axis=-1, keepdims=True)
    want = _flash_backward_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
                                jnp.asarray(lse[:, 0].numpy()[..., None]), jnp.asarray(delta),
                                scale, block_q=256, block_k=256, interpret=True)
    got = tatt.plain_attention_bwd(_port(q), _port(k), _port(v), out, _port(g), lse, scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, :, 0].numpy(), np.asarray(b), atol=GRAD_TOL)


# (shape, groups, eps, silu, dtype): SiLU on and off, B > 1, 1 to 16
# channels a group, f32 and bf16
GN_BWD_CASES = [((2, 8, 8, 64), 32, 1e-5, True, torch.float32),
                ((2, 8, 8, 64), 32, 1e-5, False, torch.float32),
                ((1, 7, 9, 96), 8, 1e-6, True, torch.float32),
                ((3, 5, 6, 48), 48, 1e-5, True, torch.float32),
                ((2, 6, 6, 32), 4, 1e-6, False, torch.float32),
                ((1, 16, 16, 512), 32, 1e-6, True, torch.float32),
                ((2, 8, 8, 64), 32, 1e-5, True, torch.bfloat16),
                ((1, 7, 9, 96), 8, 1e-6, False, torch.bfloat16),
                ((2, 8, 8, 320), 32, 1e-5, True, torch.bfloat16)]


@pytest.mark.parametrize("shape,groups,eps,silu,dtype", GN_BWD_CASES)
def test_groupnorm_plain_backward_matches_autograd_and_jax_vjp(shape, groups, eps, silu, dtype):
    rng = np.random.default_rng(4)
    c = shape[-1]
    x = (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    tx, tscale, tbias, tdy = (torch.from_numpy(a).to(dtype) for a in (x, scale, bias, dy))
    got = tgn.plain_groupnorm_silu_backward(tx, tdy, tscale, tbias, groups, eps, silu)
    leaves = [t.clone().requires_grad_() for t in (tx, tscale, tbias)]
    out = tgn.plain_groupnorm_silu(*leaves, groups, eps, silu)
    want = torch.autograd.grad(out, leaves, tdy)
    refs = [want]
    if dtype == torch.float32:
        refs.append([torch.from_numpy(np.array(r)) for r in jgn._gn_bwd(
            groups, eps, silu, (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)),
            jnp.asarray(dy))])
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for ref in refs:
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            b = b.float()
            torch.testing.assert_close(a.float(), b, rtol=rtol,
                                       atol=1e-4 * float(b.abs().max()))


def _f64(rng, shape):
    return torch.from_numpy(rng.normal(size=shape)).requires_grad_()


@pytest.mark.parametrize("fn", [tatt._FlashTrainable, tatt._FlashPlainBackward])
def test_attention_functions_pass_gradcheck(fn):
    rng = np.random.default_rng(2)
    q, k, v = _f64(rng, (1, 6, 2, 4)), _f64(rng, (1, 5, 2, 4)), _f64(rng, (1, 5, 2, 4))
    assert torch.autograd.gradcheck(lambda q, k, v: fn.apply(q, k, v, 0.4), (q, k, v))


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_function_passes_gradcheck(silu):
    rng = np.random.default_rng(3)
    x = _f64(rng, (2, 3, 4, 8))
    scale, bias = _f64(rng, (8,)), _f64(rng, (8,))
    assert torch.autograd.gradcheck(
        lambda x, s, b: tgn.groupnorm_silu_trainable(x, s, b, 4, 1e-5, silu), (x, scale, bias))


def test_routing_keeps_every_gradient():
    """Under autograd, long attention and GroupNorm go through their
    Functions (K5+K6 up to d = 160, the plain backward above); without it,
    through the wrappers as in inference."""
    x = torch.randn((1, tatt.FLASH_MIN_KV, 2, 16), requires_grad=True)
    assert type(tatt.dot_product_attention(x, x, x).grad_fn).__name__ == "_FlashTrainableBackward"
    wide = torch.randn((1, tatt.FLASH_MIN_KV, 1, 192), requires_grad=True)
    out = tatt.dot_product_attention(wide, wide, wide)
    assert type(out.grad_fn).__name__ == "_FlashPlainBackwardBackward"
    with torch.no_grad():
        assert tatt.dot_product_attention(x, x, x).grad_fn is None
    layer = FusedGroupNormSiLU(16, groups=4)
    y = layer(torch.randn((1, 16, 4, 4)))  # only the layer's weights need a gradient
    assert type(y.grad_fn.next_functions[0][0]).__name__ == "_GroupNormSiLUBackward"
    y.sum().backward()
    assert layer.weight.grad is not None and layer.bias.grad is not None


def test_bwd_gate_follows_registers_and_shared_memory():
    assert all(tatt.flash_bwd_fits(d, dt) for d in (8, 40, 80, 160)
               for dt in (torch.float32, torch.bfloat16))
    assert not tatt.flash_bwd_fits(161) and not tatt.flash_bwd_fits(512)
    assert tatt.bwd_smem_bytes(160, torch.bfloat16) <= tatt.SMEM_PER_BLOCK


def test_kernel_wrappers_refuse_tensors_that_need_a_gradient():
    """The guard runs before any launch: a wrapper handed a non-CPU tensor
    that autograd tracks raises instead of returning an output with no
    grad_fn (a meta tensor stands in for the card's here)."""
    q = torch.empty((1, 4, 1, 8), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        tatt.flash_attention_fwd(q, q, q, 1.0)
    with pytest.raises(RuntimeError, match="gradient"):
        tatt.flash_attention_fwd_lse(q, q, q, 1.0)
    lse = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(RuntimeError, match="gradient"):
        tatt.flash_attention_bwd(q, q, q, q, q, lse, 1.0)
    x = torch.empty((1, 2, 2, 8), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        tgn.groupnorm_silu(x, torch.ones(8), torch.zeros(8), 4)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        tatt.flash_attention_fwd(q, q, q, 1.0)  # past the guard: the device check
