"""The port's ops (``ldiffusion_tpu_torch/ops``) against the JAX package's.

On the CPU each port op runs its plain PyTorch version; it is held against
the JAX XLA formulation at f32 (tolerance 1e-5: the same arithmetic, summed in
another order) and against the Pallas kernels in interpret mode, as
``tests/test_ops.py`` runs them (tolerance 2e-4, that file's own: the online
softmax and the blocked sums reorder more). The CUDA kernels themselves run
only on a card: ``test_torch_port_kernels.py`` holds them against the plain
versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldiffusion_tpu.ops import attention as jatt
from ldiffusion_tpu.ops import groupnorm as jgn
from ldiffusion_tpu.ops.resize import upsample_nearest_2x as j_upsample
from ldiffusion_tpu_torch.ops import attention as tatt
from ldiffusion_tpu_torch.ops import groupnorm as tgn
from ldiffusion_tpu_torch.ops.resize import upsample_nearest_2x
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

XLA_TOL = 1e-5
INTERPRET_TOL = 2e-4


@pytest.fixture(autouse=True)
def restore_modes():
    yield
    jatt.set_attention_mode("auto")
    jgn.set_groupnorm_mode("auto")


def _qkv(rng, b, sq, sk, h, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, h, d)).astype(np.float32))


def _port_attention(q, k, v):
    return tatt.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 64, 5, 4, 16),     # text cross-attention
                                         (1, 300, 300, 2, 8),   # ragged self-attention
                                         (1, 256, 256, 8, 40)])
def test_attention_plain_matches_xla(b, sq, sk, h, d):
    q, k, v = _qkv(np.random.default_rng(0), b, sq, sk, h, d)
    ref = jatt._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5)
    np.testing.assert_allclose(_port_attention(q, k, v), np.asarray(ref), atol=XLA_TOL,
                               rtol=XLA_TOL)


@pytest.mark.parametrize("mode,s,h,d", [("pallas_interpret", 512, 2, 40),         # K1
                                        ("pallas_kvgrid_interpret", 1024, 1, 64)])  # K2
def test_attention_plain_matches_pallas_interpret(mode, s, h, d):
    q, k, v = _qkv(np.random.default_rng(1), 1, s, s, h, d)
    jatt.set_attention_mode(mode)
    ref = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_port_attention(q, k, v), np.asarray(ref),
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


def test_flash_wrapper_takes_plain_path_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(2), 1, 600, 600, 2, 16))
    before = tatt.flash_attention_fwd.launches
    out = tatt.flash_attention_fwd(q, k, v, 0.25)
    assert tatt.flash_attention_fwd.launches == before  # no kernel launched
    assert torch.equal(out, tatt.plain_attention(q, k, v, 0.25))


def _gn_inputs(rng, shape, loc=0.0, spread=1.0):
    c = shape[-1]
    x = (loc + spread * rng.normal(size=shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    return x, scale, bias


def _port_gn(x, scale, bias, groups, eps, silu):
    return tgn.groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), groups, eps, silu).numpy()


@pytest.mark.parametrize("shape,groups,eps,silu", [((2, 8, 8, 64), 32, 1e-5, True),
                                                   ((1, 7, 9, 96), 8, 1e-6, False),
                                                   ((1, 16, 16, 128), 32, 1e-6, True)])
def test_groupnorm_plain_matches_xla(shape, groups, eps, silu):
    x, scale, bias = _gn_inputs(np.random.default_rng(3), shape)
    ref = jgn._xla_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                  groups, eps, silu)
    np.testing.assert_allclose(_port_gn(x, scale, bias, groups, eps, silu), np.asarray(ref),
                               atol=XLA_TOL, rtol=XLA_TOL)


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_plain_matches_pallas_k3_interpret(silu):
    x, scale, bias = _gn_inputs(np.random.default_rng(4), (2, 8, 8, 128))
    jgn.set_groupnorm_mode("pallas_interpret")
    ref = jgn.groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             groups=32, eps=1e-5, silu=silu)
    np.testing.assert_allclose(_port_gn(x, scale, bias, 32, 1e-5, silu), np.asarray(ref),
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_plain_matches_pallas_k4_interpret(silu):
    x, scale, bias = _gn_inputs(np.random.default_rng(5), (1, 32, 32, 64))
    ref = jgn._pallas_groupnorm_silu_chunked(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias), 32, 1e-6, silu,
                                             interpret=True)
    np.testing.assert_allclose(_port_gn(x, scale, bias, 32, 1e-6, silu), np.asarray(ref),
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


def test_groupnorm_variance_clamp_matches_jax():
    """Channel sums whose single-pass variance E[x²]−E[x]² comes out below
    zero (mean ≫ std): both clamp it to 0, so rstd = 1/sqrt(eps) exactly."""
    b, c, groups, n_spatial = 2, 64, 32, 100
    s_c = np.full((b, c), 1000.0 * n_spatial, np.float32)
    ss_c = np.full((b, c), (1000.0 ** 2 - 0.5) * n_spatial, np.float32)
    scale, bias = np.linspace(0.5, 1.5, c, dtype=np.float32), np.zeros(c, np.float32)
    mul, add = tgn._stats_to_affine(torch.from_numpy(s_c), torch.from_numpy(ss_c), n_spatial,
                                    groups, c, torch.from_numpy(scale), torch.from_numpy(bias),
                                    1e-5)
    jmul, jadd = jgn._stats_to_affine(jnp.asarray(s_c), jnp.asarray(ss_c), n_spatial, groups,
                                      c, jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(mul.numpy(), np.broadcast_to(scale / np.sqrt(1e-5), (b, c)),
                               rtol=XLA_TOL)
    np.testing.assert_allclose(mul.numpy(), np.asarray(jmul), rtol=XLA_TOL)
    np.testing.assert_allclose(add.numpy(), np.asarray(jadd), rtol=XLA_TOL)


def test_groupnorm_mean_much_larger_than_std_stays_finite():
    """x = 1000 + 1e-3·noise: the single-pass variance cancels (f32 ulp of
    1000² is 0.0625 ≫ the true 1e-6), so only the clamp keeps rsqrt finite."""
    x, scale, bias = _gn_inputs(np.random.default_rng(6), (1, 8, 8, 64), loc=1000.0,
                                spread=1e-3)
    out = _port_gn(x, scale, bias, 32, 1e-6, True)
    assert np.isfinite(out).all()
    ref = jgn._xla_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                  1e-6, True)
    assert np.isfinite(np.asarray(ref)).all()


@pytest.mark.parametrize("batch,hw", [(1, 1), (1, 256), (1, 1024 * 1024), (3, 1023),
                                      (2, 16384), (8, 17)])
def test_groupnorm_stats_chunks_cover_every_row(batch, hw):
    n_chunks, rows = tgn.stats_chunks(batch, hw)
    assert n_chunks * rows >= hw and (n_chunks - 1) * rows < hw
    assert batch * n_chunks <= max(tgn._TARGET_CTAS, batch)


def test_upsample_nearest_2x_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 3, 5, 4)).astype(np.float32)
    out = upsample_nearest_2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(j_upsample(jnp.asarray(x))))


def test_wrappers_raise_on_a_device_they_do_not_take():
    q = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        tatt.flash_attention_fwd(q, q, q, 1.0)
    with pytest.raises(ValueError):
        tgn.groupnorm_silu(torch.empty((1, 2, 2, 8), device="meta"), torch.ones(8),
                           torch.zeros(8), 4)
