"""The backward attention's routing between its three CUDA kernels, on the CPU.

``bwd_route`` mirrors the C dispatchers: ``"wgmma"`` (csrc/flash_bwd_wgmma.cu,
TMA + wgmma) for bf16 with d % 8 == 0, d <= 160 and 16-byte-aligned pointers;
``"mma"`` (``flash_bwd_*_mma`` in csrc/flash_attention_bwd.cu) for the other
bf16 shapes; ``"f32"`` for float32. ``wgmma_bwd_config`` mirrors the kernel's
compile-time ``Cfg``: its shared memory must stay within the H100's 232,448
bytes a block, as the C ``static_assert``s demand (the card's tests also hold
the formula against the library's own), and its tiles within the 240
registers a consumer thread has. The kernels themselves run only on a card
(``test_torch_port_kernels.py``); the plain version they are held against is
checked here against the JAX package's backward at the card tests' shapes.

Tolerances: against the XLA vjp in f32, 1e-5 — the same function summed in
another order (the vjp forms dS from rowsum(P ∘ dP), the port from
rowsum(dO ∘ O), equal in exact arithmetic); against the Pallas kernel in
interpret mode, 2e-4 as ``tests/test_torch_port_autograd.py`` (the kernel
sums in blocks).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.ops import attention as jatt
from ldiffusion_tpu_torch.ops import attention as tatt
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

SMEM_PER_BLOCK = 232448
CONSUMER_REGS = 240


@pytest.mark.parametrize("d,dtype,aligned,route", [
    # SD-v1.5's UNet head dims (levels 0-2) and the smallest
    (40, torch.bfloat16, True, "wgmma"), (80, torch.bfloat16, True, "wgmma"),
    (160, torch.bfloat16, True, "wgmma"), (8, torch.bfloat16, True, "wgmma"),
    # d % 8 != 0: strides TMA cannot take
    (100, torch.bfloat16, True, "mma"), (20, torch.bfloat16, True, "mma"),
    # past the wgmma backward's head-dim limit (the mma kernels refuse it too)
    (168, torch.bfloat16, True, "mma"),
    # a pointer off the 16-byte grid
    (40, torch.bfloat16, False, "mma"), (160, torch.bfloat16, False, "mma"),
    # float32 keeps the exact FMA kernels
    (40, torch.float32, True, "f32"), (100, torch.float32, False, "f32")])
def test_bwd_route(d, dtype, aligned, route):
    assert tatt.bwd_route(d, dtype, aligned) == route


def test_bwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tatt.bwd_route(40, torch.float16, True)


# one head dim per compiled configuration: DP = 16..160 in steps of 16
@pytest.mark.parametrize("d", range(16, 161, 16))
def test_wgmma_bwd_config_fits_shared_memory_and_registers(d):
    cfg = tatt.wgmma_bwd_config(d)
    assert cfg["dp"] == d
    assert cfg["smem"] <= SMEM_PER_BLOCK
    assert cfg["stages"] >= 2
    assert cfg["dp"] % (cfg["swizzle"] // 2) == 0  # whole swizzle atoms
    assert cfg["own"] % cfg["tile_rows"] == 0  # owned tiles load as whole boxes
    # a dK/dV consumer thread: dK + dV (DP f32), S^T and dP^T (R f32), their
    # bf16 A fragments (R/2), within the 240 registers setmaxnreg gives it
    rows = cfg["tile_rows"]
    assert cfg["dp"] + rows + rows // 2 <= CONSUMER_REGS


@pytest.mark.parametrize("d,dp,swizzle,tile_rows", [
    (40, 48, 32, 64), (80, 80, 32, 32), (160, 160, 64, 32), (8, 16, 32, 64),
    (64, 64, 128, 64), (96, 96, 64, 32), (128, 128, 128, 32)])
def test_wgmma_bwd_padding_and_tiles_per_head_dim(d, dp, swizzle, tile_rows):
    cfg = tatt.wgmma_bwd_config(d)
    assert (cfg["dp"], cfg["swizzle"], cfg["tile_rows"], cfg["own"]) == (dp, swizzle,
                                                                         tile_rows, 128)


def test_flash_bwd_fits_covers_both_routes():
    for d in range(8, tatt.BWD_MAX_HEAD_DIM + 1, 8):
        assert tatt.bwd_route(d, torch.bfloat16, True) == "wgmma"
        assert tatt.wgmma_bwd_config(d)["smem"] <= SMEM_PER_BLOCK
        assert tatt.flash_bwd_fits(d, torch.bfloat16), d
    for d in (1, 20, 100, 136, 159):  # the mma kernels' shapes
        assert tatt.flash_bwd_fits(d, torch.bfloat16), d
    assert not tatt.flash_bwd_fits(168) and not tatt.flash_bwd_fits(512)


def _to_bhsd(x):
    """(B, S, H, D) torch → (B·H, S, D) numpy, the JAX kernels' layout, in
    memory of its own: on the CPU ``jnp.asarray`` may alias a numpy buffer,
    and a torch-owned one would then be read by XLA while it runs
    asynchronously beside torch."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy().copy()


def _to_bshd(x, b, h):
    x = np.array(x)  # a writable copy
    return torch.from_numpy(x.reshape(b, h, *x.shape[1:])).permute(0, 2, 1, 3)


def _inputs(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.normal(size=(b, sq, h, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, sk, h, d)).astype(np.float32)) for _ in range(2))
    return q, k, v, g


def test_plain_attention_bwd_matches_xla_vjp_at_the_route_test_shape():
    """B = 2, H = 3, ragged Sq/Sk (the card's wgmma backward tests)."""
    b, h, d = 2, 3, 40
    q, k, v, g = _inputs(15, b, 515, 1000, h, d)
    scale = d ** -0.5
    out, lse = tatt.plain_attention_lse(q, k, v, scale)
    got = tatt.plain_attention_bwd(q, k, v, out, g, lse, scale)
    want = jax.block_until_ready(jatt._xla_attention_bwd(
        *(jnp.asarray(_to_bhsd(x)) for x in (q, k, v, g)), scale))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _to_bshd(w, b, h).numpy(), atol=1e-5, rtol=1e-5)


def test_plain_attention_bwd_matches_pallas_k6_interpret_at_d80():
    """d = 80 (UNet level 1) at a block-divisible length, B = 1, H = 2."""
    b, h, d, s = 1, 2, 80, 512
    q, k, v, g = _inputs(16, b, s, s, h, d)
    scale = d ** -0.5
    out, lse = tatt.plain_attention_lse(q, k, v, scale)
    delta = tatt.attention_delta(out, g)
    want = jatt._flash_backward_bhsd(
        *(jnp.asarray(_to_bhsd(x)) for x in (q, k, v, g)),
        jnp.asarray(lse.reshape(b * h, s, 1).numpy()),
        jnp.asarray(delta.reshape(b * h, s, 1).numpy()), scale, block_q=256, block_k=256,
        interpret=True)
    want = jax.block_until_ready(want)
    got = tatt.plain_attention_bwd(q, k, v, out, g, lse, scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _to_bshd(w, b, h).numpy(), atol=2e-4)


def test_attention_delta_matches_the_jax_expression():
    """Δ = rowsum(dO ∘ O) as ``_flash_bwd`` computes it (:395), f32 sums of
    40 exact products: summation order only."""
    rng = np.random.default_rng(17)
    o, g = (rng.normal(size=(2, 300, 3, 40)).astype(np.float32) for _ in range(2))
    want = jnp.sum(jnp.asarray(g) * jnp.asarray(o), axis=-1)  # (B, S, H)
    got = tatt.attention_delta(torch.from_numpy(o), torch.from_numpy(g))  # (B, H, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1), atol=1e-5,
                               rtol=1e-6)


def test_cpu_tensors_count_no_route():
    x = torch.zeros((1, 600, 1, 40), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 600))
    before = dict(tatt.flash_attention_bwd.launches_by_route)
    launches = tatt.flash_attention_bwd.launches
    tatt.flash_attention_bwd(x, x, x, x, x, lse, 0.1)
    assert tatt.flash_attention_bwd.launches_by_route == before
    assert tatt.flash_attention_bwd.launches == launches
    assert set(before) == set(tatt.BWD_ROUTES)
