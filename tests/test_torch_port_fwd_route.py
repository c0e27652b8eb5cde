"""The forward attention's routing between its three CUDA kernels, on the CPU.

``fwd_route`` mirrors the C dispatchers: ``"wgmma"`` (csrc/flash_fwd_wgmma.cu,
TMA + wgmma) for bf16 with d % 8 == 0, d <= 512 and 16-byte-aligned pointers;
``"mma"`` (``flash_fwd_mma``) for the other bf16 shapes, which TMA cannot
address; ``"f32"`` for float32. ``wgmma_config`` mirrors the kernel's
compile-time ``Cfg``: its shared memory must stay within the H100's 232,448
bytes a block, as the C ``static_assert``s demand (the card's tests also hold
the formula against the library's own). The kernels themselves run only on a
card (``test_torch_port_kernels.py``); the plain version they are held
against is checked here against the JAX package at the new route's test shape.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldiffusion_tpu.ops import attention as jatt
from ldiffusion_tpu_torch.ops import attention as tatt
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

SMEM_PER_BLOCK = 232448


@pytest.mark.parametrize("d,dtype,aligned,route", [
    # SD-v1.5's head dims: UNet levels 0-2 and the VAE mid-block
    (40, torch.bfloat16, True, "wgmma"), (80, torch.bfloat16, True, "wgmma"),
    (160, torch.bfloat16, True, "wgmma"), (512, torch.bfloat16, True, "wgmma"),
    (8, torch.bfloat16, True, "wgmma"),
    # d % 8 != 0: strides TMA cannot take
    (100, torch.bfloat16, True, "mma"), (300, torch.bfloat16, True, "mma"),
    # a pointer off the 16-byte grid
    (40, torch.bfloat16, False, "mma"), (512, torch.bfloat16, False, "mma"),
    # float32 keeps the exact FMA kernel at any head dim
    (40, torch.float32, True, "f32"), (512, torch.float32, True, "f32"),
    (100, torch.float32, False, "f32")])
def test_fwd_route(d, dtype, aligned, route):
    assert tatt.fwd_route(d, dtype, aligned) == route


def test_fwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tatt.fwd_route(40, torch.float16, True)


# one head dim per compiled configuration: DP = 16..256 in steps of 16, and
# the two split configurations (DP = 384, 512)
@pytest.mark.parametrize("d", [*range(16, 257, 16), 384, 512])
def test_wgmma_config_fits_shared_memory(d):
    cfg = tatt.wgmma_config(d)
    assert cfg["dp"] == d
    assert cfg["smem"] <= SMEM_PER_BLOCK
    assert cfg["stages"] >= 2
    assert cfg["dp"] % (cfg["swizzle"] // 2) == 0  # whole swizzle atoms
    if cfg["split"]:  # each warpgroup's half of O starts on an atom
        assert (cfg["dp"] // 2) % (cfg["swizzle"] // 2) == 0
    # S (64 x keys) and O (64 x columns) in f32, P in bf16: registers a
    # thread, within the consumers' 240 with room for addresses and the softmax
    cols = cfg["dp"] // 2 if cfg["split"] else cfg["dp"]
    assert cols // 2 + cfg["keys"] // 2 + cfg["keys"] // 4 <= 176


@pytest.mark.parametrize("d,dp,swizzle", [(40, 48, 32), (80, 80, 32), (160, 160, 64),
                                          (512, 512, 128), (8, 16, 32), (64, 64, 128),
                                          (96, 96, 64), (264, 384, 128)])
def test_wgmma_padding_per_head_dim(d, dp, swizzle):
    cfg = tatt.wgmma_config(d)
    assert (cfg["dp"], cfg["swizzle"]) == (dp, swizzle)


@pytest.mark.parametrize("d,keys,rows", [(40, 128, 128), (80, 128, 128), (160, 64, 128),
                                          (512, 32, 64)])
def test_key_tile_per_head_dim(d, keys, rows):
    cfg = tatt.wgmma_config(d)
    assert (cfg["keys"], cfg["rows"]) == (keys, rows)


def test_every_wgmma_head_dim_has_a_configuration():
    for d in range(8, 513, 8):
        cfg = tatt.wgmma_config(d)
        assert d <= cfg["dp"] and cfg["smem"] <= SMEM_PER_BLOCK, d


def test_plain_attention_matches_xla_at_the_route_test_shape():
    """B = 2, H = 3, ragged Sq/Sk (the card's wgmma tests): the plain version
    against the JAX XLA formulation, f32, 1e-5 (summation order only)."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 515, 3, 40)).astype(np.float32)
    k, v = (rng.normal(size=(2, 1000, 3, 40)).astype(np.float32) for _ in range(2))
    ref = jatt._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40 ** -0.5)
    out = tatt.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), 40 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_count_no_route():
    x = torch.zeros((1, 600, 1, 40), dtype=torch.bfloat16)
    before = dict(tatt.flash_attention_fwd_lse.launches_by_route)
    tatt.flash_attention_fwd_lse(x, x, x, 0.1)
    assert tatt.flash_attention_fwd_lse.launches_by_route == before
    assert set(before) == set(tatt.FWD_ROUTES)
