"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports nothing of JAX, so it also runs on a machine that
has PyTorch and a card but no JAX, without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Tolerances (atol, atol_rms, rtol), every element within
atol + atol_rms*rms(plain) + rtol*|plain|: in f32 only the summation order
differs (attention 2e-5 + 1e-4|p|, GroupNorm 1e-5 + 1e-4|p|). In bf16 the
attention output shrinks with the sequence (a typical |o| is about
sqrt(e/S)), so its absolute term scales with rms(plain): the kernel rounds
the unnormalised probabilities to bf16 where the plain version rounds the
normalised ones (about 2^-9*rms(o) an output: 2^-5*rms), and both round the
output, at most one ulp apart (2^-6|p|). GroupNorm outputs are O(1), with
the same f32 math; its bf16 output may differ by one ulp (1e-3 + 1.6e-2|p|).

The forward's logsumexp (K5) differs from the plain one by summation order
only: bf16 inputs make exact f32 products in both (1e-4 + 1e-5|p| in f32,
1e-3 + 1e-5|p| in bf16). The backward (K6) has the forward's tolerances: in
bf16 both versions round P and dS to bf16 before their products and the
results to bf16 (2^-5·rms + 2^-6|p|); in f32 only the order of the sums over
up to a few thousand terms differs, relative to each gradient's scale
(1e-4·rms + 1e-4|p|).
"""
import numpy as np
import pytest
import torch

from ldiffusion_tpu_torch.ops import attention as tatt
from ldiffusion_tpu_torch.ops import groupnorm as tgn

ATTN_TOL = {torch.float32: (2e-5, 0.0, 1e-4), torch.bfloat16: (0.0, 2 ** -5, 2 ** -6)}
LSE_TOL = {torch.float32: (1e-4, 0.0, 1e-5), torch.bfloat16: (1e-3, 0.0, 1e-5)}
BWD_TOL = {torch.float32: (0.0, 1e-4, 1e-4), torch.bfloat16: (0.0, 2 ** -5, 2 ** -6)}
# the training path's head dims (40, 80 at 512² images; 160 the widest K6
# takes; 16 and 64 in the tiny f32 runs), ragged lengths and d % 8 != 0
BWD_CASES = [(torch.float32, (2, 300, 3, 8)), (torch.float32, (1, 1024, 2, 16)),
             (torch.float32, (1, 777, 2, 64)), (torch.float32, (1, 333, 1, 160)),
             (torch.bfloat16, (1, 1024, 2, 40)), (torch.bfloat16, (1, 1024, 2, 80)),
             (torch.bfloat16, (1, 1024, 2, 160)), (torch.bfloat16, (2, 300, 3, 8)),
             (torch.bfloat16, (1, 129, 2, 100)), (torch.bfloat16, (1, 515, 2, 136))]
GN_TOL = {torch.float32: (1e-5, 0.0, 1e-4), torch.bfloat16: (1e-3, 0.0, 1.6e-2)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _normal(rng, shape, dtype, device, loc=0.0, spread=1.0):
    x = (loc + spread * rng.normal(size=shape)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _assert_close(out, ref, tol):
    atol, atol_rms, rtol = tol
    ref = ref.float()
    atol += atol_rms * float(ref.pow(2).mean().sqrt())
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 300, 3, 8)), (torch.float32, (1, 777, 2, 64)),
    (torch.float32, (1, 600, 1, 512)),
    # the 1024² path's head dims (40, 80, 160, 512), then the bf16 kernel's
    # other head-dim splits and its unaligned-load path (d % 8 != 0)
    (torch.bfloat16, (1, 1024, 2, 40)), (torch.bfloat16, (1, 1024, 2, 80)),
    (torch.bfloat16, (1, 1024, 2, 160)), (torch.bfloat16, (1, 1024, 1, 512)),
    (torch.bfloat16, (2, 300, 3, 8)), (torch.bfloat16, (1, 129, 2, 100)),
    (torch.bfloat16, (1, 333, 1, 300))])
def test_flash_kernel_matches_plain_on_gpu(cuda, dtype, shape):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, shape, dtype, cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = tatt.flash_attention_fwd.launches
    out = tatt.flash_attention_fwd(q, k, v, scale)
    assert tatt.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, tatt.plain_attention(q, k, v, scale), ATTN_TOL[dtype])


# the generation tail's shapes at SD-v1.5 width: tools.sample's 512² image
# (UNet level-0 and level-1 self-attention, the VAE mid-block's) and the
# multimodal augment of four 256² RGB-D pairs (UNet + ControlNet level-0
# self-attention, the VAE mid-block's); GroupNorm over the UNet's, the
# ControlNet's and the VAE's batch-4 maps
GEN_ATTN_SHAPES = [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 4096, 1, 512),
                   (4, 1024, 8, 40), (4, 1024, 1, 512)]
GEN_GN_SHAPES = [((4, 32, 32, 320), 1e-5, True), ((4, 32, 32, 320), 1e-6, False),
                 ((4, 8, 8, 2560), 1e-5, True), ((4, 64, 64, 512), 1e-6, True),
                 ((4, 128, 128, 256), 1e-6, True), ((4, 256, 256, 128), 1e-6, True),
                 ((4, 256, 256, 256), 1e-6, True)]


# bench.py's program at SD-v1.5 width (512², batch 8): UNet level-0 and
# level-1 self-attention and the VAE mid-block's (d = 512); GroupNorm over its
# batch-8 maps, the smallest and largest on each side of the routes' boundary
# and the VAE mid-block's map without SiLU
BENCH_ATTN_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 4096, 1, 512)]
BENCH_GN_SHAPES = [((8, 8, 8, 1280), 1e-5, True), ((8, 32, 32, 1280), 1e-5, True),
                   ((8, 64, 64, 320), 1e-5, True), ((8, 64, 64, 320), 1e-6, False),
                   ((8, 32, 32, 1920), 1e-5, True), ((8, 64, 64, 960), 1e-5, True),
                   ((8, 64, 64, 512), 1e-6, False), ((8, 256, 256, 256), 1e-6, True),
                   ((8, 512, 512, 128), 1e-6, True), ((8, 512, 512, 256), 1e-6, True)]


def _check_attention_takes_wgmma(cuda, shape):
    rng = np.random.default_rng(30)
    q, k, v = (_normal(rng, shape, torch.bfloat16, cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    routes = dict(tatt.flash_attention_fwd.launches_by_route)
    out = tatt.flash_attention_fwd(q, k, v, scale)
    assert tatt.flash_attention_fwd.launches_by_route == {**routes, "wgmma": routes["wgmma"] + 1}
    _assert_close(out, tatt.plain_attention(q, k, v, scale), ATTN_TOL[torch.bfloat16])


def _check_groupnorm_takes_its_route(cuda, shape, eps, silu):
    x, scale, bias = _gn_inputs(np.random.default_rng(31), shape, torch.bfloat16, torch.float32,
                                cuda)
    routes = dict(tgn.groupnorm_silu.launches_by_route)
    route = tgn.gn_route(shape[0], shape[1] * shape[2], shape[3], 32, torch.bfloat16, True)
    out = tgn.groupnorm_silu(x, scale, bias, 32, eps, silu)
    assert tgn.groupnorm_silu.launches_by_route == {**routes, route: routes[route] + 1}
    _assert_close(out, tgn.plain_groupnorm_silu(x, scale, bias, 32, eps, silu),
                  GN_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GEN_ATTN_SHAPES)
def test_generation_attention_takes_wgmma_and_matches_plain(cuda, shape):
    _check_attention_takes_wgmma(cuda, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu", GEN_GN_SHAPES)
def test_generation_batch4_groupnorm_takes_its_route_and_matches_plain(cuda, shape, eps, silu):
    _check_groupnorm_takes_its_route(cuda, shape, eps, silu)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BENCH_ATTN_SHAPES)
def test_bench_program_attention_takes_wgmma_and_matches_plain(cuda, shape):
    _check_attention_takes_wgmma(cuda, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu", BENCH_GN_SHAPES)
def test_bench_program_groupnorm_takes_its_route_and_matches_plain(cuda, shape, eps, silu):
    _check_groupnorm_takes_its_route(cuda, shape, eps, silu)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_other_key_lengths(cuda, dtype):
    rng = np.random.default_rng(1)
    q = _normal(rng, (2, 200, 2, 64), dtype, cuda)
    k, v = (_normal(rng, (2, 77, 2, 64), dtype, cuda) for _ in range(2))
    out = tatt.flash_attention_fwd(q, k, v, 0.125)
    _assert_close(out, tatt.plain_attention(q, k, v, 0.125), ATTN_TOL[dtype])


@pytest.mark.gpu
def test_long_self_attention_goes_to_the_kernel(cuda):
    rng = np.random.default_rng(2)
    long_ = _normal(rng, (1, tatt.FLASH_MIN_KV, 2, 16), torch.bfloat16, cuda)
    short = _normal(rng, (1, 5, 2, 16), torch.bfloat16, cuda)
    before = tatt.flash_attention_fwd.launches
    tatt.dot_product_attention(long_, long_, long_)
    assert tatt.flash_attention_fwd.launches == before + 1
    tatt.dot_product_attention(long_, short, short)  # text cross-attention stays plain
    assert tatt.flash_attention_fwd.launches == before + 1


@pytest.mark.gpu
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    big = torch.zeros((1, 8, 1, 520), device=cuda)
    with pytest.raises(ValueError):
        tatt.flash_attention_fwd(big, big, big, 1.0)
    half = torch.zeros((1, 8, 1, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tatt.flash_attention_fwd(half, half, half, 1.0)
    strided = torch.zeros((1, 2, 8, 16), device=cuda).transpose(1, 2)  # (B, H, S, D) memory
    with pytest.raises(ValueError):
        tatt.flash_attention_fwd(strided, strided, strided, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,groups", [
    (torch.float32, (2, 7, 9, 96), 8), (torch.float32, (1, 64, 64, 64), 32),
    (torch.bfloat16, (1, 16, 16, 1280), 32), (torch.bfloat16, (3, 33, 31, 640), 32),
    (torch.bfloat16, (1, 256, 256, 128), 32)])
@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_kernel_matches_plain_on_gpu(cuda, dtype, shape, groups, silu):
    rng = np.random.default_rng(3)
    x = _normal(rng, shape, dtype, cuda, loc=0.5, spread=2.0)
    c = shape[-1]
    scale = _normal(rng, (c,), torch.float32, cuda, loc=1.0, spread=0.1)
    bias = _normal(rng, (c,), torch.float32, cuda, spread=0.1)
    before = tgn.groupnorm_silu.launches
    routes = dict(tgn.groupnorm_silu.launches_by_route)
    out = tgn.groupnorm_silu(x, scale, bias, groups, 1e-5, silu)
    assert tgn.groupnorm_silu.launches == before + 1
    route = tgn.gn_route(shape[0], shape[1] * shape[2], c, groups, dtype, True)
    assert tgn.groupnorm_silu.launches_by_route == {**routes, route: routes[route] + 1}
    assert out.dtype == dtype and out.shape == x.shape
    _assert_close(out, tgn.plain_groupnorm_silu(x, scale, bias, groups, 1e-5, silu),
                  GN_TOL[dtype])


@pytest.mark.gpu
def test_groupnorm_kernel_clamps_the_variance(cuda):
    """mean ≫ std: the single-pass variance cancels, and can come out below
    zero, where rsqrt would give NaN; the kernel clamps it at 0. (The value
    itself is cancellation noise that depends on the summation order, so it
    is not compared with the plain version.)"""
    rng = np.random.default_rng(4)
    x = _normal(rng, (1, 8, 8, 64), torch.float32, cuda, loc=1000.0, spread=1e-3)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    out = tgn.groupnorm_silu(x, ones, zeros, 32, 1e-6, True)
    assert bool(torch.isfinite(out).all())


def _bwd_inputs(rng, shape, dtype, device):
    q, k, v, do = (_normal(rng, shape, dtype, device) for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = tatt.plain_attention_lse(q, k, v, scale)
    return q, k, v, do, out, lse, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", BWD_CASES)
def test_flash_lse_kernel_matches_plain_on_gpu(cuda, dtype, shape):
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, shape, dtype, cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = tatt.flash_attention_fwd_lse.launches
    out, lse = tatt.flash_attention_fwd_lse(q, k, v, scale)
    assert tatt.flash_attention_fwd_lse.launches == before + 1
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    ref_out, ref_lse = tatt.plain_attention_lse(q, k, v, scale)
    _assert_close(out, ref_out, ATTN_TOL[dtype])
    _assert_close(lse, ref_lse, LSE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", BWD_CASES)
def test_flash_bwd_kernel_matches_plain_on_gpu(cuda, dtype, shape):
    q, k, v, do, out, lse, scale = _bwd_inputs(np.random.default_rng(6), shape, dtype, cuda)
    before = tatt.flash_attention_bwd.launches
    grads = tatt.flash_attention_bwd(q, k, v, out, do, lse, scale)
    assert tatt.flash_attention_bwd.launches == before + 1
    for g, ref in zip(grads, tatt.plain_attention_bwd(q, k, v, out, do, lse, scale)):
        assert g.dtype == dtype and g.shape == ref.shape
        _assert_close(g, ref, BWD_TOL[dtype])


@pytest.mark.gpu
def test_flash_bwd_kernel_takes_other_key_lengths_and_is_deterministic(cuda):
    rng = np.random.default_rng(7)
    q, do = (_normal(rng, (2, 200, 2, 40), torch.bfloat16, cuda) for _ in range(2))
    k, v = (_normal(rng, (2, 77, 2, 40), torch.bfloat16, cuda) for _ in range(2))
    out, lse = tatt.plain_attention_lse(q, k, v, 0.15)
    first = tatt.flash_attention_bwd(q, k, v, out, do, lse, 0.15)
    for g, ref in zip(first, tatt.plain_attention_bwd(q, k, v, out, do, lse, 0.15)):
        _assert_close(g, ref, BWD_TOL[torch.bfloat16])
    again = tatt.flash_attention_bwd(q, k, v, out, do, lse, 0.15)
    assert all(torch.equal(a, b) for a, b in zip(first, again))  # no atomics


@pytest.mark.gpu
def test_flash_bwd_keeps_no_score_matrix(cuda):
    """The port's counterpart of tests/test_flash_backward.py:95-116: at 4096
    tokens the backward (the wgmma route, its pre-pass buffers included)
    stays far below one 4·S²-byte f32 score matrix."""
    s = 4096
    q, k, v, do = (_normal(np.random.default_rng(8), (1, s, 8, 40), torch.bfloat16, cuda)
                   for _ in range(4))
    out, lse = tatt.flash_attention_fwd_lse(q, k, v, 40 ** -0.5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(tatt.flash_attention_bwd.launches_by_route)
    tatt.flash_attention_bwd(q, k, v, out, do, lse, 40 ** -0.5)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 4 * s * s
    assert tatt.flash_attention_bwd.launches_by_route["wgmma"] == before["wgmma"] + 1


@pytest.mark.gpu
def test_bwd_gate_matches_the_kernels_shared_memory(cuda):
    import ctypes

    from ldiffusion_tpu_torch.ops import _build

    fn = _build.library("flash_attention_bwd").ldt_flash_attention_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(1, 200):
            assert fn(d, code) == tatt.bwd_smem_bytes(d, dtype), (d, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 512])
def test_attention_gradients_match_plain_autograd_on_gpu(cuda, dtype, d):
    """dot_product_attention under autograd: K5+K6 at d = 40 (bf16 through
    the wgmma backward), the forward kernel + plain backward at d = 512;
    against autograd through the plain version in f32 (autograd of the bf16
    plain version would round dP)."""
    rng = np.random.default_rng(9)
    shape = (1, 600, 1, d)
    q, k, v, do = (_normal(rng, shape, dtype, cuda) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tatt.dot_product_attention(*leaves)
    assert out.grad_fn is not None
    before = dict(tatt.flash_attention_bwd.launches_by_route)
    grads = torch.autograd.grad(out, leaves, do)
    if d == 40:
        route = tatt.bwd_route(d, dtype, True)
        assert route == ("wgmma" if dtype == torch.bfloat16 else "f32")
        assert tatt.flash_attention_bwd.launches_by_route[route] == before[route] + 1
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(tatt.plain_attention(*ref_leaves, d ** -0.5), ref_leaves,
                              do.float())
    for g, r in zip(grads, ref):
        _assert_close(g, r, BWD_TOL[dtype])


@pytest.mark.gpu
def test_kernel_wrappers_refuse_outputs_that_would_drop_the_gradient(cuda):
    """A CUDA tensor that requires grad never leaves a raw kernel wrapper
    without a grad_fn: the wrappers raise, the layers route to the Functions."""
    from ldiffusion_tpu_torch.models.layers import FusedGroupNormSiLU

    x = torch.randn((1, 600, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        tatt.flash_attention_fwd(x, x, x, 0.25)
    assert tatt.dot_product_attention(x, x, x).grad_fn is not None
    with torch.no_grad():
        tatt.flash_attention_fwd(x, x, x, 0.25)  # inference: the kernel as before
    m = torch.randn((1, 8, 8, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        tgn.groupnorm_silu(m, torch.ones(64, device=cuda), torch.zeros(64, device=cuda), 32)
    layer = FusedGroupNormSiLU(64).to(cuda)
    y = layer(m.permute(0, 3, 1, 2))
    assert y.grad_fn is not None
    y.sum().backward()
    assert m.grad is not None and layer.weight.grad is not None


# The "wgmma" route (csrc/flash_fwd_wgmma.cu): every compiled split of the
# head dim that the model and the tests reach, ragged Sq/Sk that are
# multiples of neither the query block (128 or 64 rows) nor the key tile (32,
# 64 or 128 keys), and B = 2, H = 3 so that the tensor maps' strides across
# heads and batches are exercised.
WGMMA_DIMS = [8, 40, 64, 80, 128, 160, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("d", WGMMA_DIMS)
@pytest.mark.parametrize("with_lse", [False, True])
def test_wgmma_route_matches_plain_on_gpu(cuda, d, with_lse):
    rng = np.random.default_rng(10)
    sk = 1100 if with_lse else 1000  # odd and even counts of 32-, 64- and 128-key tiles
    q = _normal(rng, (2, 515, 3, d), torch.bfloat16, cuda)
    k, v = (_normal(rng, (2, sk, 3, d), torch.bfloat16, cuda) for _ in range(2))
    scale = d ** -0.5
    fn = tatt.flash_attention_fwd_lse if with_lse else tatt.flash_attention_fwd
    before = dict(fn.launches_by_route)
    res = fn(q, k, v, scale)
    assert fn.launches_by_route["wgmma"] == before["wgmma"] + 1
    if with_lse:
        out, lse = res
        ref, ref_lse = tatt.plain_attention_lse(q, k, v, scale)
        _assert_close(lse, ref_lse, LSE_TOL[torch.bfloat16])
    else:
        out, ref = res, tatt.plain_attention(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _assert_close(out, ref, ATTN_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_path_shapes_take_the_wgmma_route(cuda):
    """SD-v1.5's head dims go to the wgmma kernel; d = 100 (d % 8 != 0) and an
    unaligned q stay on mma.sync; asking the wgmma kernel for d = 100 raises."""
    rng = np.random.default_rng(12)
    routes = tatt.flash_attention_fwd.launches_by_route
    for d, route in ((40, "wgmma"), (80, "wgmma"), (160, "wgmma"), (512, "wgmma"),
                     (100, "mma")):
        x = _normal(rng, (1, 600, 1, d), torch.bfloat16, cuda)
        before = dict(routes)
        tatt.flash_attention_fwd(x, x, x, d ** -0.5)
        assert routes[route] == before[route] + 1 and sum(routes.values()) == \
            sum(before.values()) + 1, (d, route)
    flat = _normal(rng, (600 * 40 + 1,), torch.bfloat16, cuda)
    q = flat[1:].view(1, 600, 1, 40)  # 2 bytes off the 16-byte grid
    k = _normal(rng, (1, 600, 1, 40), torch.bfloat16, cuda)
    before = dict(routes)
    out = tatt.flash_attention_fwd(q, k, k, 0.15)
    assert routes["mma"] == before["mma"] + 1
    _assert_close(out, tatt.plain_attention(q, k, k, 0.15), ATTN_TOL[torch.bfloat16])
    x = _normal(rng, (1, 600, 1, 100), torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match="wgmma"):
        tatt._launch_fwd("flash_attention_fwd", x, x, x, 0.1, None, route="wgmma")


@pytest.mark.gpu
def test_wgmma_config_matches_the_kernels_shared_memory(cuda):
    import ctypes

    from ldiffusion_tpu_torch.ops import _build

    fn = _build.library("flash_fwd_wgmma").ldt_flash_attention_fwd_wgmma_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for d in range(1, 530):
        takes = d % 8 == 0 and 8 <= d <= 512
        assert fn(d) == (tatt.wgmma_config(d)["smem"] if takes else -1), d


# The backward's "wgmma" route (csrc/flash_bwd_wgmma.cu): every head dim it
# compiles that the model and the tests reach, ragged Sq/Sk that are
# multiples of neither the 128 rows a CTA owns nor the streamed tile (32 or
# 64 rows), and B = 2, H = 3 so that the tensor maps' strides and the pre-pass
# buffers' rows across heads and batches are exercised.
WGMMA_BWD_DIMS = [8, 40, 64, 80, 128, 160]


@pytest.mark.gpu
@pytest.mark.parametrize("d", WGMMA_BWD_DIMS)
@pytest.mark.parametrize("sk", [1000, 1100])
def test_wgmma_bwd_route_matches_plain_on_gpu(cuda, d, sk):
    rng = np.random.default_rng(13)
    q, do = (_normal(rng, (2, 515, 3, d), torch.bfloat16, cuda) for _ in range(2))
    k, v = (_normal(rng, (2, sk, 3, d), torch.bfloat16, cuda) for _ in range(2))
    scale = d ** -0.5
    out, lse = tatt.plain_attention_lse(q, k, v, scale)
    before = dict(tatt.flash_attention_bwd.launches_by_route)
    grads = tatt.flash_attention_bwd(q, k, v, out, do, lse, scale)
    assert tatt.flash_attention_bwd.launches_by_route["wgmma"] == before["wgmma"] + 1
    for g, ref in zip(grads, tatt.plain_attention_bwd(q, k, v, out, do, lse, scale)):
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape
        _assert_close(g, ref, BWD_TOL[torch.bfloat16])
    again = tatt.flash_attention_bwd(q, k, v, out, do, lse, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


@pytest.mark.gpu
def test_path_shapes_take_the_wgmma_bwd_route(cuda):
    """SD-v1.5's head dims go to the wgmma backward; d = 100 (d % 8 != 0) and
    an unaligned q stay on mma.sync; asking the wgmma kernel for d = 100
    raises."""
    rng = np.random.default_rng(14)
    routes = tatt.flash_attention_bwd.launches_by_route

    def run(q, route):
        k, v, do = (_normal(rng, q.shape, torch.bfloat16, cuda) for _ in range(3))
        scale = q.shape[-1] ** -0.5
        out, lse = tatt.plain_attention_lse(q, k, v, scale)
        before = dict(routes)
        grads = tatt.flash_attention_bwd(q, k, v, out, do, lse, scale)
        assert routes[route] == before[route] + 1 and sum(routes.values()) == \
            sum(before.values()) + 1, (q.shape, route)
        for g, ref in zip(grads, tatt.plain_attention_bwd(q, k, v, out, do, lse, scale)):
            _assert_close(g, ref, BWD_TOL[torch.bfloat16])

    for d, route in ((40, "wgmma"), (80, "wgmma"), (160, "wgmma"), (100, "mma")):
        run(_normal(rng, (1, 600, 1, d), torch.bfloat16, cuda), route)
    flat = _normal(rng, (600 * 40 + 1,), torch.bfloat16, cuda)
    run(flat[1:].view(1, 600, 1, 40), "mma")  # q 2 bytes off the 16-byte grid
    x = _normal(rng, (1, 600, 1, 100), torch.bfloat16, cuda)
    _, lse = tatt.plain_attention_lse(x, x, x, 0.1)
    with pytest.raises(RuntimeError, match="wgmma"):
        tatt._launch_bwd("flash_attention_bwd", x, x, x, x, x, lse, 0.1, route="wgmma")


@pytest.mark.gpu
def test_wgmma_bwd_config_matches_the_kernels_shared_memory(cuda):
    import ctypes

    from ldiffusion_tpu_torch.ops import _build

    fn = _build.library("flash_bwd_wgmma").ldt_flash_attention_bwd_wgmma_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for d in range(1, 201):
        takes = tatt.bwd_route(d, torch.bfloat16, True) == "wgmma"
        assert takes == (d % 8 == 0 and 8 <= d <= tatt.BWD_MAX_HEAD_DIM), d
        assert fn(d) == (tatt.wgmma_bwd_config(d)["smem"] if takes else -1), d


# The GroupNorm routes (csrc/groupnorm_sm90.cu): the resident route (one
# cluster launch) and the streamed pair, each forced at maps of the 1024² ROI
# and the 512² step (every resident map also streams), f32 and odd channel
# counts, B > 1 and ragged rows; C·itemsize not a multiple of 16 (36 bf16)
# and x off the 16-byte grid take the streamed route's scalar variant.
GN_ROUTE_CASES = [
    (torch.bfloat16, (1, 16, 16, 1280), 32), (torch.bfloat16, (1, 64, 64, 320), 32),
    (torch.bfloat16, (1, 64, 64, 960), 32), (torch.bfloat16, (1, 128, 128, 320), 32),
    (torch.bfloat16, (1, 128, 128, 960), 32), (torch.bfloat16, (1, 256, 256, 256), 32),
    (torch.bfloat16, (3, 33, 31, 640), 32), (torch.bfloat16, (2, 300, 29, 128), 32),
    (torch.float32, (2, 7, 9, 96), 8), (torch.float32, (1, 64, 64, 64), 32),
    (torch.bfloat16, (2, 7, 9, 96), 8), (torch.bfloat16, (1, 9, 9, 36), 4)]


def _gn_inputs(rng, shape, dtype, sdtype, device, loc=0.5, spread=2.0):
    c = shape[-1]
    x = _normal(rng, shape, dtype, device, loc=loc, spread=spread)
    scale = _normal(rng, (c,), sdtype, device, loc=1.0, spread=0.1)
    bias = _normal(rng, (c,), sdtype, device, spread=0.1)
    return x, scale, bias


def _gn_routes(shape, groups, dtype, aligned=True):
    b, h, w, c = shape
    takes_resident = tgn.vectorised(c, dtype, aligned) and \
        tgn.gn_resident_config(b, h * w, c, groups, dtype) is not None
    return ("resident", "stream") if takes_resident else ("stream",)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,groups", GN_ROUTE_CASES)
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
def test_groupnorm_routes_match_plain_and_repeat_bitwise_on_gpu(cuda, dtype, shape, groups,
                                                               sdtype):
    x, scale, bias = _gn_inputs(np.random.default_rng(20), shape, dtype, sdtype, cuda)
    for silu in (True, False):
        ref = tgn.plain_groupnorm_silu(x, scale, bias, groups, 1e-5, silu)
        for route in _gn_routes(shape, groups, dtype):
            out, took = tgn._launch("gn", x, scale, bias, groups, 1e-5, silu, route=route)
            assert took == route and out.dtype == dtype and out.shape == x.shape
            _assert_close(out, ref, GN_TOL[dtype])
            again, _ = tgn._launch("gn", x, scale, bias, groups, 1e-5, silu, route=route)
            assert torch.equal(out, again), route  # fixed summation order, no atomics


@pytest.mark.gpu
def test_groupnorm_path_shapes_take_their_routes_and_count_one_launch(cuda):
    """The UNet's maps go resident, the ROI's 128²×960 and the VAE's large
    maps stream, odd C and unaligned x stream (scalar variant); each call
    moves one route's count by exactly one."""
    rng = np.random.default_rng(21)
    cases = [((1, 16, 16, 1280), 32, 0, "resident"), ((1, 64, 64, 960), 32, 0, "resident"),
             ((1, 128, 128, 320), 32, 0, "resident"), ((1, 128, 128, 960), 32, 0, "stream"),
             ((1, 512, 512, 256), 32, 0, "stream"), ((1, 9, 9, 36), 4, 0, "stream"),
             ((2, 7, 9, 96), 8, 1, "stream")]
    counts = tgn.groupnorm_silu.launches_by_route
    for shape, groups, offset, route in cases:
        x, scale, bias = _gn_inputs(rng, shape, torch.bfloat16, torch.bfloat16, cuda)
        if offset:  # the same values 2 bytes off the 16-byte grid
            flat = torch.empty(x.numel() + offset, device=cuda, dtype=x.dtype)
            x = flat[offset:].view(shape).copy_(x)
        before = dict(counts)
        out = tgn.groupnorm_silu(x, scale, bias, groups, 1e-6, True)
        assert counts == {**before, route: before[route] + 1}, (shape, route)
        _assert_close(out, tgn.plain_groupnorm_silu(x, scale, bias, groups, 1e-6, True),
                      GN_TOL[torch.bfloat16])
    x = torch.zeros((1, 9, 9, 36), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="resident"):  # TMA cannot take 72-byte rows
        tgn._launch("gn", x, x[0, 0, 0], x[0, 0, 0], 4, 1e-5, True, route="resident")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (1, 64, 64, 320)])
def test_groupnorm_routes_clamp_the_variance(cuda, shape):
    """mean ≫ std: the single-pass variance cancels and can come out below
    zero; both routes clamp it at 0, so the output stays finite."""
    x = _normal(np.random.default_rng(22), shape, torch.float32, cuda, loc=1000.0, spread=1e-3)
    c = shape[-1]
    ones, zeros = torch.ones(c, device=cuda), torch.zeros(c, device=cuda)
    for route in ("resident", "stream"):
        out, _ = tgn._launch("gn", x, ones, zeros, 32, 1e-6, True, route=route)
        assert bool(torch.isfinite(out).all()), route


def _check_resident_config(entry: str, backward: bool):
    """``gn_resident_config(..., backward)`` against the library's ``entry``."""
    import ctypes

    from ldiffusion_tpu_torch.ops import _build

    fn = getattr(_build.library("groupnorm_sm90"), entry)
    # the backward's entry takes no narrowest slice: it launches with MIN_SLICE_BYTES
    fn.argtypes = [ctypes.c_int] * (5 if backward else 6) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    keys = ("groups", "cluster", "rows", "box_rows", "boxes", "smem")
    out = (ctypes.c_int * 6)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for b in (1, 2, 3):
            for side in (1, 7, 8, 16, 31, 64, 128, 181, 256, 512):
                for c, groups in ((64, 32), (96, 8), (128, 32), (256, 32), (320, 32),
                                  (512, 32), (640, 32), (960, 32), (1280, 32), (1920, 32),
                                  (2560, 32), (36, 4), (100, 4)):
                    for min_slice in (tgn.MIN_SLICE_BYTES,) if backward else \
                            (32, tgn.MIN_SLICE_BYTES):
                        cfg = tgn.gn_resident_config(b, side * side, c, groups, dtype,
                                                     min_slice, backward=backward)
                        got = fn(b, side * side, c, groups, code,
                                 *(() if backward else (min_slice,)), out)
                        assert got == (cfg is not None), (b, side, c, dtype, min_slice)
                        if cfg is not None:
                            assert list(out) == [cfg[k] for k in keys], (b, side, c, dtype)


@pytest.mark.gpu
def test_gn_resident_config_matches_the_kernels_choice(cuda):
    _check_resident_config("ldt_groupnorm_resident_config", False)


# The GroupNorm backward (csrc/groupnorm_sm90.cu: `gn_resident_bwd`; the
# streamed `gn_stream_bwd_stats`, `gn_finalize_bwd_stats`,
# `gn_stream_bwd_partials`, `gn_finalize_bwd`, `gn_apply_bwd`) against
# `plain_groupnorm_silu_backward`. Both compute in f32 and differ only in
# summation order and the kernel's fast exponential: f32 gradients within
# 1e-4 of their rms plus 1e-4|p|; bf16 ones (dx in x's type, dscale and
# dbias in the parameters') one rounding apart, 2^-7|p| plus 2^-9 of the rms.
GN_BWD_TOL = {torch.float32: (0.0, 1e-4, 1e-4), torch.bfloat16: (0.0, 2 ** -9, 2 ** -7)}


def _gn_bwd_inputs(rng, shape, dtype, sdtype, device):
    x, scale, bias = _gn_inputs(rng, shape, dtype, sdtype, device)
    return x, _normal(rng, shape, dtype, device), scale, bias


def _check_gn_bwd(got, want):
    for out, ref in zip(got, want):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        _assert_close(out, ref, GN_BWD_TOL[out.dtype])


@pytest.mark.gpu
def test_gn_resident_bwd_config_matches_the_kernels_choice(cuda):
    _check_resident_config("ldt_groupnorm_resident_bwd_config", True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,groups", GN_ROUTE_CASES)
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
def test_groupnorm_backward_routes_match_plain_and_repeat_bitwise_on_gpu(cuda, dtype, shape,
                                                                        groups, sdtype):
    """Each route the backward takes for the shape (every resident map also
    streams), SiLU on and off; without parameter gradients dx is the same."""
    x, dy, scale, bias = _gn_bwd_inputs(np.random.default_rng(24), shape, dtype, sdtype, cuda)
    b, h, w, c = shape
    takes_resident = tgn.vectorised(c, dtype, True) and \
        tgn.gn_resident_config(b, h * w, c, groups, dtype, backward=True) is not None
    for silu in (True, False):
        ref = tgn.plain_groupnorm_silu_backward(x, dy, scale, bias, groups, 1e-5, silu)
        for route in ("resident", "stream") if takes_resident else ("stream",):
            *got, took = tgn._launch_bwd(x, dy, scale, bias, groups, 1e-5, silu, True, route=route)
            assert took == route
            _check_gn_bwd(got, ref)
            *again, _ = tgn._launch_bwd(x, dy, scale, bias, groups, 1e-5, silu, True, route=route)
            assert all(torch.equal(a, o) for a, o in zip(again, got)), route
            dx, dscale, dbias, _ = tgn._launch_bwd(x, dy, scale, bias, groups, 1e-5, silu, False,
                                                   route=route)
            assert dscale is None and dbias is None and torch.equal(dx, got[0]), route


# stage 1's maps: the 512² UNet's (64² latents), the 512² VAE decode's, and
# the 64²-image batch-8 step's UNet (8² latents) and VAE decode
GN_BWD_STAGE1 = [((1, 64, 64, 320), 1e-5, True, "resident"),
                 ((1, 16, 16, 1280), 1e-5, True, "resident"),
                 ((1, 256, 256, 512), 1e-6, True, "stream"),
                 ((1, 512, 512, 128), 1e-6, True, "stream"),
                 ((8, 8, 8, 320), 1e-5, True, "resident"),
                 ((8, 64, 64, 128), 1e-6, False, "resident")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu,route", GN_BWD_STAGE1)
def test_groupnorm_backward_stage1_maps_take_their_route_and_repeat_bitwise(cuda, shape, eps,
                                                                           silu, route):
    x, dy, scale, bias = _gn_bwd_inputs(np.random.default_rng(25), shape, torch.bfloat16,
                                        torch.bfloat16, cuda)
    b, h, w, c = shape
    assert tgn.gn_route(b, h * w, c, 32, torch.bfloat16, True, backward=True) == route
    fn = tgn.groupnorm_silu_backward
    counts, launches = dict(fn.launches_by_route), fn.launches
    got = fn(x, dy, scale, bias, 32, eps, silu)
    assert fn.launches_by_route == {**counts, route: counts[route] + 1}
    assert fn.launches == launches + 1
    again = fn(x, dy, scale, bias, 32, eps, silu)
    assert all(torch.equal(a, o) for a, o in zip(again, got))
    _check_gn_bwd(got, tgn.plain_groupnorm_silu_backward(x, dy, scale, bias, 32, eps, silu))


@pytest.mark.gpu
def test_groupnorm_backward_takes_unaligned_and_strided_gradients(cuda):
    """dy off the 16-byte grid: the streamed route's scalar variant; dy a
    channels-first view: copied to NHWC first."""
    x, dy, scale, bias = _gn_bwd_inputs(np.random.default_rng(26), (2, 9, 7, 96),
                                        torch.bfloat16, torch.float32, cuda)
    ref = tgn.plain_groupnorm_silu_backward(x, dy, scale, bias, 8, 1e-6, True)
    flat = torch.empty(dy.numel() + 1, device=cuda, dtype=dy.dtype)
    off = flat[1:].view(dy.shape).copy_(dy)
    counts = dict(tgn.groupnorm_silu_backward.launches_by_route)
    _check_gn_bwd(tgn.groupnorm_silu_backward(x, off, scale, bias, 8, 1e-6, True), ref)
    assert tgn.groupnorm_silu_backward.launches_by_route["stream"] == counts["stream"] + 1
    strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    _check_gn_bwd(tgn.groupnorm_silu_backward(x, strided, scale, bias, 8, 1e-6, True), ref)


@pytest.mark.gpu
def test_fused_groupnorm_layer_differentiates_through_the_backward_kernel(cuda, monkeypatch):
    """``FusedGroupNormSiLU`` under autograd on the card: the kernel forward
    and the backward kernel, never the plain route."""
    from ldiffusion_tpu_torch.models.layers import FusedGroupNormSiLU

    rng = np.random.default_rng(27)
    layer = FusedGroupNormSiLU(320).to(device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(_normal(rng, (320,), torch.bfloat16, cuda, loc=1.0, spread=0.1))
        layer.bias.copy_(_normal(rng, (320,), torch.bfloat16, cuda, spread=0.1))
    x = _normal(rng, (1, 64, 64, 320), torch.bfloat16, cuda, loc=0.5, spread=2.0)
    dy = _normal(rng, (1, 64, 64, 320), torch.bfloat16, cuda)
    ref = tgn.plain_groupnorm_silu_backward(x, dy, layer.weight.detach(), layer.bias.detach(),
                                            32, 1e-5, True)

    def plain(*args, **kwargs):
        raise AssertionError("the plain route ran on the card")

    monkeypatch.setattr(tgn, "plain_groupnorm_silu_backward", plain)
    monkeypatch.setattr(tgn, "plain_groupnorm_silu", plain)
    fwd, bwd = tgn.groupnorm_silu.launches, tgn.groupnorm_silu_backward.launches
    leaf = x.permute(0, 3, 1, 2).detach().requires_grad_()  # NCHW, channels last in memory
    y = layer(leaf)
    y.backward(dy.permute(0, 3, 1, 2))
    assert tgn.groupnorm_silu.launches == fwd + 1
    assert tgn.groupnorm_silu_backward.launches == bwd + 1
    _check_gn_bwd((leaf.grad.permute(0, 2, 3, 1), layer.weight.grad, layer.bias.grad), ref)


def _on_a_fresh_thread(fn):
    """``fn()`` on a new thread, whose first CUDA call it makes."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # raised again on the test's thread
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


# Each launcher that encodes a TMA tensor map, as a new thread's first CUDA
# call. The encoding needs a current context, which such a thread lacks
# until the launcher binds one (autograd's worker thread can be one).
@pytest.mark.gpu
@pytest.mark.parametrize("launcher", ["flash_fwd", "flash_bwd", "gn_resident", "gn_resident_bwd"])
def test_tma_launchers_run_as_a_fresh_threads_first_cuda_call(cuda, launcher):
    rng = np.random.default_rng(28)
    if launcher.startswith("flash"):
        q, k, v, do, out, lse, scale = _bwd_inputs(rng, (1, 1024, 2, 40), torch.bfloat16, cuda)
        route = "wgmma"
        if launcher == "flash_fwd":
            fn, args, tol = tatt.flash_attention_fwd, (q, k, v, scale), ATTN_TOL
            refs = (tatt.plain_attention(q, k, v, scale),)
        else:
            fn, tol = tatt.flash_attention_bwd, BWD_TOL
            args = (q, k, v, out.contiguous(), do, lse, scale)
            refs = tatt.plain_attention_bwd(*args)
    else:
        x, dy, scale, bias = _gn_bwd_inputs(rng, (1, 64, 64, 320), torch.bfloat16,
                                            torch.bfloat16, cuda)
        route = "resident"
        if launcher == "gn_resident":
            fn, args, tol = tgn.groupnorm_silu, (x, scale, bias, 32, 1e-5, True), GN_TOL
            refs = (tgn.plain_groupnorm_silu(*args),)
        else:
            fn, args, tol = tgn.groupnorm_silu_backward, (x, dy, scale, bias, 32, 1e-5, True), None
            refs = tgn.plain_groupnorm_silu_backward(*args)
    torch.cuda.synchronize()
    before = dict(fn.launches_by_route)
    got = _on_a_fresh_thread(lambda: fn(*args))
    torch.cuda.synchronize()
    assert fn.launches_by_route == {**before, route: before[route] + 1}
    if tol is None:
        _check_gn_bwd(got, refs)
    else:
        for g, ref in zip((got,) if torch.is_tensor(got) else got, refs):
            _assert_close(g, ref, tol[torch.bfloat16])


@pytest.mark.gpu
def test_int8_codes_wait_in_host_memory_until_the_first_int8_forward(cuda):
    """A cast down to the card quantizes the f32 weight, and its codes stay
    in host memory: a model run only in bf16 holds none on the card. The
    first int8 forward moves them to the card, equal to the codes taken
    there."""
    from ldiffusion_tpu_torch.models.layers import QConv, cast_keeping_int8_weights
    from ldiffusion_tpu_torch.ops import quant

    torch.manual_seed(0)
    m = QConv(256, 256, 3, padding=1)  # a width the int8 gate quantizes
    want = quant._sym_quant(m.weight.detach().to(cuda), dims=(1, 2, 3))
    cast_keeping_int8_weights(m, device=cuda, dtype=torch.bfloat16)
    (codes, scales), bias = m._wq
    assert codes.device.type == scales.device.type == bias.device.type == "cpu"
    x = torch.randn(1, 256, 16, 16, device=cuda, dtype=torch.bfloat16)
    before = quant.int8_conv.launches
    try:
        quant.set_quant_mode("int8")
        with torch.no_grad():
            m(x)
    finally:
        quant.set_quant_mode("none")
    assert quant.int8_conv.launches - before == 1
    (codes, scales), bias = m._wq
    assert codes.device == scales.device == bias.device == m.weight.device
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])


def _tiny_predictor(device, dtype=torch.float32):
    from ldiffusion_tpu_torch.models.dynunet import DynUNet
    from ldiffusion_tpu_torch.models.layers import init_random_
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    plan = SegPlan(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
                   strides=(1, 2, 2), n_conv_per_stage=2, num_classes=7, in_channels=3,
                   normalization="zscore_image", intensity_properties={},
                   median_shape=(64, 64), batch_dice=True)
    sd = init_random_(DynUNet(plan.network_config()), torch.Generator().manual_seed(3))
    return SlidingWindowPredictor(plan, [sd.state_dict()] * 2, dtype=dtype, device=device)


def _launch_counts():
    from ldiffusion_tpu_torch.core import graphs

    return graphs._read(graphs.counters())


@pytest.mark.gpu
def test_captured_programs_replay_the_eager_first_use_bitwise(cuda):
    """A tiny predictor's bucket (2 folds, 3 x 3 tiles) and a tiny fused
    tissue program (the tiny SD components, f32): the first use runs eagerly,
    the second captures and replays, the third replays; every replay's output
    equals the eager one bit for bit, and each use raises the kernels'
    launches by route and ``network_forwards`` by the same amounts."""
    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.core import graphs
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_text_emb

    pred = _tiny_predictor(cuda)
    rng = np.random.default_rng(4)
    image = rng.random((64, 64, 3)).astype(np.float32)
    comps = SDComponents.random(device=cuda)
    model = LDiffusionModel("random:tiny", "tissue", components=comps, device=cuda)
    with torch.inference_mode():
        fused = model._make_fused_predict(pred, trajectory_text_emb(comps, 1))
    img_norm = torch.from_numpy(rng.normal(size=(64, 64, 3)).astype(np.float32))
    cases = [("bucket", lambda: pred.predict(image), lambda: pred._predict_cache),
             ("fused", lambda: [t.cpu() for t in fused(img_norm, want_transformed=True)],
              lambda: fused.programs)]
    for name, call, cache in cases:
        outs, deltas = [], []
        for _ in range(3):
            before, forwards = _launch_counts(), pred.network_forwards
            out = call()
            torch.cuda.synchronize()
            deltas.append((graphs._diff(_launch_counts(), before),
                           pred.network_forwards - forwards))
            outs.append(out)
        (program,) = cache().values()
        assert program.graph is not None and program.replays == 2, name
        assert deltas[1] == deltas[0] and deltas[2] == deltas[0], (name, deltas)
        assert deltas[0][1] > 0, name
        for out in outs[1:]:
            for a, b in zip(out if isinstance(out, list) else [out],
                            outs[0] if isinstance(outs[0], list) else [outs[0]]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), name
    # the fused program launched the port's kernels, each use the same count
    launched = dict(zip([getattr(o, "__name__", "") + "." + a for o, a in graphs.counters()],
                        deltas[0][0]))
    assert launched["groupnorm_silu.launches"] > 0


@pytest.mark.gpu
def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """No fallback: a capture that would grow the streamed GroupNorm's
    workspace (memory the graph's pool would own) raises, and the program
    holds no graph."""
    from ldiffusion_tpu_torch.core.graphs import Program

    x = torch.randn(1, 7, 9, 6, device=cuda)  # 24-byte rows: the streamed route
    assert tgn.gn_route(1, 63, 6, 2, torch.float32, True) == "stream"
    scale, bias = torch.ones(6, device=cuda), torch.zeros(6, device=cuda)
    program = Program(lambda t: tgn.groupnorm_silu(t, scale, bias, groups=2), cuda)
    program(x)  # eager: the workspace grows here
    monkeypatch.setattr(tgn, "_workspaces", {})  # as if it never had
    with pytest.raises(RuntimeError, match="workspace"):
        program(x)
    assert program.graph is None


# ---------------------------------------------------------------------------
# training steps as captured programs
# ---------------------------------------------------------------------------

def _max_diff(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _held_to_eager(captured: dict, eager: dict, eager_again: dict):
    """The captured route against the eager one: bit-equal where two eager
    runs from the same state are, else within twice their difference (the
    spread of kernels whose sums take no fixed order)."""
    for name in eager:
        spread = _max_diff(eager_again[name], eager[name])
        diff = _max_diff(captured[name], eager[name])
        assert diff <= 2 * spread, (name, diff, spread)


def _stage1_trainer(cuda, mesh=None):
    import warnings

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        info = InfoNceLoss.create(device=cuda, num_anchors=16, num_negatives=64, num_classes=4)
    cfg = DiffusionTrainConfig(num_inference_steps=10, compute_dtype="float32", num_classes=4)
    return DiffusionWarmupTrainer(SDComponents.random(seed=1, device=cuda), cfg, info_nce=info,
                                  mesh=mesh)


def _whole(t):
    """A tensor whole (a DTensor gathered), copied."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def _stage1_run(cuda, captured: bool, steps: int = 4, mesh=None):
    """``steps`` stage-1 steps from seed 1's weights and generator: through
    ``train_step`` (eager, capture, replays) or ``step_fn`` each time (under
    FSDP2 over ``mesh``)."""
    from ldiffusion_tpu_torch.core import graphs

    tr = _stage1_trainer(cuda, mesh)
    rng = np.random.default_rng(2)
    labels = np.zeros((1, 64, 64), np.int64)
    labels[:, :32], labels[:, 32:, :32], labels[:, :8, :8] = 1, 2, 3
    values, launches = [], []
    for _ in range(steps):
        images = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
        before = _launch_counts()
        if captured:
            m = tr.train_step(images, labels)
            values.append([m[k] for k in ("loss", "content", "contrast", "grad_norm")])
        else:
            out = tr.step_fn(torch.from_numpy(images).to(cuda), torch.from_numpy(labels).to(cuda))
            values.append(torch.stack(out).tolist())
        torch.cuda.synchronize()
        launches.append(graphs._diff(_launch_counts(), before))
    st = tr.opt.state
    return tr, launches, {"values": [torch.tensor(values)],
                          "masters": [_whole(m) for m in tr.master],
                          "exp_avg": [_whole(st[m]["exp_avg"]) for m in tr.master],
                          "exp_avg_sq": [_whole(st[m]["exp_avg_sq"]) for m in tr.master]}


@pytest.mark.gpu
def test_captured_stage1_steps_match_the_eager_route(cuda):
    """A tiny stage-1 trainer (f32): 4 steps through ``train_step`` (eager,
    captured, 2 replays, the Laplace and contrastive draws inside the graph)
    against 4 calls of ``step_fn`` from the same weights and generator seed:
    losses, norms, masters and AdamW moments; each replayed step launches
    what the eager step did."""
    tr, launches, captured = _stage1_run(cuda, True)
    _, _, eager = _stage1_run(cuda, False)
    _, _, eager_again = _stage1_run(cuda, False)
    _held_to_eager(captured, eager, eager_again)
    (program,) = tr.program.programs.values()
    assert program.graph is not None and program.replays == 3
    assert launches[1] == launches[0] and launches[3] == launches[0], launches


@pytest.fixture
def nccl_mesh(cuda):
    """A world-size-1 NCCL process group and its (data, fsdp, tensor) mesh,
    left after the test."""
    import socket

    import torch.distributed as dist

    from ldiffusion_tpu_torch.core.config import MeshConfig
    from ldiffusion_tpu_torch.core.dist import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    device = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=device)
    try:
        yield make_mesh(MeshConfig(), device=device)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_captured_fsdp2_stage1_steps_match_the_eager_route(cuda, nccl_mesh, monkeypatch):
    """The tiny stage-1 trainer under FSDP2 (NCCL, world size 1): 4 steps
    through ``train_step`` (eager, captured with FSDP2's all-gathers and
    reduce-scatters and the losses' all-reduce inside the graph, 2 replays)
    against 4 calls of ``step_fn`` from the same weights and seed: losses,
    norms, gathered masters and AdamW moments; each replayed step launches
    what the eager step did. cuDNN held to its deterministic algorithms, as
    for the segmentors: FSDP2 hands the convolutions contiguous f32 weights,
    for which cuDNN's default algorithms made two eager runs differ (masters
    1.2e-6 apart) and a twice-that bound a coin toss."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr, launches, captured = _stage1_run(cuda, True, mesh=nccl_mesh)
    _, _, eager = _stage1_run(cuda, False, mesh=nccl_mesh)
    _, _, eager_again = _stage1_run(cuda, False, mesh=nccl_mesh)
    _held_to_eager(captured, eager, eager_again)
    (program,) = tr.program.programs.values()
    assert program.graph is not None and program.replays == 3
    assert all(hasattr(m, "to_local") for m in tr.master)
    assert tr.opt.param_groups[0]["capturable"]
    assert launches[1] == launches[0] and launches[3] == launches[0], launches


def _seg_trainer(cuda, root, plan_3d: bool = False, name: str = "nnUNetTrainer", augment=None,
                 mesh=None):
    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    if plan_3d:
        plan = SegPlan3D(patch_size=(8, 16, 16), batch_size=2, spacing=(1.0, 1.0, 1.0),
                         features_per_stage=(8, 16, 32),
                         strides=((1, 1, 1), (2, 2, 2), (1, 2, 2)),
                         kernel_sizes=((3, 3, 3),) * 3, n_conv_per_stage=2, num_classes=3,
                         in_channels=1, normalization="zscore", median_shape=(10, 20, 20),
                         batch_dice=True)
    else:
        plan = SegPlan(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
                       strides=(1, 2, 2), n_conv_per_stage=2, num_classes=4, in_channels=3,
                       normalization="zscore_image", intensity_properties={},
                       median_shape=(48, 48), batch_dice=True)
    variant = get_variant(name, base=SegmentorTrainConfig(compute_dtype="float32"))
    return SegmentorTrainer(plan, variant.config, output_dir=str(root), variant=variant,
                            augment=augment, device=cuda, mesh=mesh)


def _seg_batch(rng, tr):
    shape = (tr.plan.batch_size, *tr.plan.patch_size)
    data = rng.normal(size=(*shape, tr.net_config.in_channels)).astype(np.float32)
    seg = rng.integers(-1, tr.plan.num_classes, shape).astype(np.int32)
    return data, seg


def _seg_run(cuda, root, captured: bool, plan_3d: bool, steps: int = 4, mesh=None):
    """``steps`` train steps (the lr changed before each) of a tiny
    segmentor (its DA on): through ``train_step`` (eager, captured, replays)
    or ``step_fn`` (data-parallel over ``mesh``)."""
    tr = _seg_trainer(cuda, root, plan_3d, mesh=mesh)
    rng = np.random.default_rng(5)
    losses = []
    for k in range(steps):
        lr = 0.01 * (1 - k / 10)
        if captured:
            losses.append(float(tr.train_step(*_seg_batch(rng, tr), lr=lr)))
        else:
            rate = torch.full((), lr, dtype=torch.float32, device=cuda)
            losses.append(float(tr.step_fn(*tr._to_device(*_seg_batch(rng, tr)), rate)[0]))
    return tr, {"losses": [torch.tensor(losses)],
                "params": [p.detach().clone() for p in tr.net.parameters()],
                "momentum": list(tr._momentum_state().values())}


@pytest.mark.gpu
@pytest.mark.parametrize("plan_3d", [False, True])
def test_captured_segmentor_steps_match_the_eager_route(cuda, tmp_path, monkeypatch, plan_3d):
    """A tiny 2D and 3D segmentor (f32, SGD, the default device DA), cuDNN
    held to its deterministic algorithms (under its default ones two eager
    runs of the 3D steps were not bit-equal): 4 train steps through their
    program against the step function called eagerly, from the same seed;
    then, on the trained parameters, 3 validation steps through their
    program (eager, captured, replayed) against ``_val_counts`` called
    eagerly on the same batches."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr, captured = _seg_run(cuda, tmp_path / "a", True, plan_3d)
    _, eager = _seg_run(cuda, tmp_path / "b", False, plan_3d)
    _, eager_again = _seg_run(cuda, tmp_path / "c", False, plan_3d)
    _held_to_eager(captured, eager, eager_again)
    tr.net.eval()
    rng = np.random.default_rng(6)
    val = {"program": [], "eager": [], "eager_again": []}
    with torch.no_grad():
        for _ in range(3):
            batch = _seg_batch(rng, tr)
            val["program"].extend(t.clone() for t in tr.val_step(*batch))
            for run in ("eager", "eager_again"):
                val[run].extend(tr._val_counts(*tr._to_device(*batch)))
    _held_to_eager({"val": val["program"]}, {"val": val["eager"]}, {"val": val["eager_again"]})
    (train,), (program,) = tr.train_program.programs.values(), tr.val_program.programs.values()
    assert train.replays == 3 and program.replays == 2


@pytest.mark.gpu
@pytest.mark.parametrize("plan_3d", [False, True])
def test_captured_mesh_segmentor_steps_match_the_eager_route(cuda, nccl_mesh, tmp_path,
                                                             monkeypatch, plan_3d):
    """The tiny 2D and 3D segmentors data-parallel over the mesh (NCCL,
    world size 1; the gradients' all-reduce, the batch Dice's sums and the
    loss's sum inside the graph), cuDNN deterministic: 4 train steps through
    their program against ``step_fn`` called eagerly, then 3 validation
    steps through their program against ``_val_step`` called eagerly."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr, captured = _seg_run(cuda, tmp_path / "a", True, plan_3d, mesh=nccl_mesh)
    _, eager = _seg_run(cuda, tmp_path / "b", False, plan_3d, mesh=nccl_mesh)
    _, eager_again = _seg_run(cuda, tmp_path / "c", False, plan_3d, mesh=nccl_mesh)
    _held_to_eager(captured, eager, eager_again)
    tr.net.eval()
    rng = np.random.default_rng(6)
    val = {"program": [], "eager": [], "eager_again": []}
    with torch.no_grad():
        for _ in range(3):
            batch = _seg_batch(rng, tr)
            val["program"].extend(t.clone() for t in tr.val_step(*batch))
            for run in ("eager", "eager_again"):
                val[run].extend(tr._val_step(*tr._to_device(*batch)))
    _held_to_eager({"val": val["program"]}, {"val": val["eager"]}, {"val": val["eager_again"]})
    (train,), (program,) = tr.train_program.programs.values(), tr.val_program.programs.values()
    assert train.replays == 3 and program.replays == 2
    assert tr.mesh is not None and tr.group is not None


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nnUNetTrainer", "nnUNetTrainerAdam", "nnUNetTrainerAdan"])
def test_a_replay_after_a_resume_reads_the_loaded_state(cuda, tmp_path, name):
    """A trainer whose step is captured loads a checkpoint of 3 steps ago
    (parameters and optimizer buffers written in place), and its next
    replay gives what a fresh trainer's eager step from that checkpoint
    gives (DA off: the generators' positions differ)."""
    from ldiffusion_tpu_torch.data.augment import AugmentConfig

    off = AugmentConfig(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0,
                        p_brightness=0.0, p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0,
                        p_gamma=0.0, p_mirror=0.0)
    rng = np.random.default_rng(9)
    tr = _seg_trainer(cuda, tmp_path / "t", name=name, augment=off)
    batches = [_seg_batch(rng, tr) for _ in range(6)]
    for b in batches[:3]:
        tr.train_step(*b, lr=0.01)
    path = str(tmp_path / "checkpoint.pkl")
    tr.save_checkpoint(path)
    for b in batches[3:5]:
        tr.train_step(*b, lr=0.005)
    tr.load_checkpoint(path)
    (program,) = tr.train_program.programs.values()
    replays = program.replays
    tr.train_step(*batches[5])
    assert program.replays == replays + 1
    after = {}
    for run in ("fresh", "fresh_again"):
        fresh = _seg_trainer(cuda, tmp_path / run, name=name, augment=off)
        fresh.load_checkpoint(path)
        fresh.train_step(*batches[5])  # a first use: eager
        after[run] = [p.detach().clone() for p in fresh.net.parameters()]
    _held_to_eager({"params": [p.detach() for p in tr.net.parameters()]},
                   {"params": after["fresh"]}, {"params": after["fresh_again"]})


@pytest.mark.gpu
def test_a_training_capture_that_fails_raises(cuda, monkeypatch):
    """No fallback for a training program either: a step (forward through
    the streamed GroupNorm, backward, an update) whose capture would grow
    the GroupNorm's workspace raises, and the program holds no graph."""
    from ldiffusion_tpu_torch.core.graphs import TrainProgram

    x = torch.randn(1, 7, 9, 6, device=cuda)  # 24-byte rows: the streamed route
    w = torch.ones(6, device=cuda, requires_grad=True)
    bias = torch.zeros(6, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def step(t):
        noisy = t + torch.rand(t.shape, generator=gen, device=cuda)
        loss = tgn.groupnorm_silu_trainable(noisy, w, bias, groups=2).square().mean()
        loss.backward()
        with torch.no_grad():
            w.sub_(0.1 * w.grad)
        w.grad = None
        return loss.detach()

    program = TrainProgram(step, cuda, generators=[gen])
    program(x)  # eager: the workspace grows here
    monkeypatch.setattr(tgn, "_workspaces", {})  # as if it never had
    with pytest.raises(RuntimeError, match="workspace"):
        program(x)
    assert program.graph is None


# ---------------------------------------------------------------------------
# the cell level's and the dataset builder's programs
# ---------------------------------------------------------------------------

# the dataset build's DiffusionTransform(batch_size=2) at 1024²: the ROI's
# attention and GroupNorm shapes at batch 2 (chip_smoke.py's B2_*_SHAPES)
B2_ATTN_SHAPES = [(2, 16384, 8, 40), (2, 4096, 8, 80), (2, 1024, 8, 160), (2, 16384, 1, 512)]
B2_GN_SHAPES = [((2, 16, 16, 1280), 1e-5, True), ((2, 16, 16, 2560), 1e-5, True),
                ((2, 16, 16, 1280), 1e-6, False), ((2, 64, 64, 320), 1e-5, True),
                ((2, 64, 64, 960), 1e-5, True), ((2, 128, 128, 320), 1e-6, False),
                ((2, 128, 128, 640), 1e-5, True), ((2, 128, 128, 512), 1e-6, True),
                ((2, 128, 128, 960), 1e-5, True), ((2, 256, 256, 256), 1e-6, True),
                ((2, 256, 256, 512), 1e-6, True), ((2, 512, 512, 256), 1e-6, True),
                ((2, 1024, 1024, 128), 1e-6, True), ((2, 1024, 1024, 128), 1e-5, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", B2_ATTN_SHAPES)
def test_batch2_transform_attention_takes_wgmma_and_matches_plain(cuda, shape):
    _check_attention_takes_wgmma(cuda, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu", B2_GN_SHAPES)
def test_batch2_transform_groupnorm_takes_its_route_and_matches_plain(cuda, shape, eps, silu):
    _check_groupnorm_takes_its_route(cuda, shape, eps, silu)


def _tiny_cell(cuda):
    """A tiny flow proposer (features 8-16) and a tiny-encoder classifier on
    the card, and two 64² images with their instance maps."""
    from ldiffusion_tpu_torch.cell.classifier import CellSegClassifier
    from ldiffusion_tpu_torch.cell.instance import FlowNetProposer
    from ldiffusion_tpu_torch.models.resnet import ResNetConfig

    rng = np.random.default_rng(21)
    images, insts = [], []
    yy, xx = np.mgrid[:64, :64]
    for _ in range(2):
        inst = np.zeros((64, 64), np.int32)
        for k in range(1, 9):
            cy, cx = rng.integers(8, 56, 2)
            inst[((yy - cy) ** 2 + (xx - cx) ** 2 <= 25) & (inst == 0)] = k
        img = np.full((64, 64, 3), 0.1, np.float32) + 0.03 * rng.random((64, 64, 3),
                                                                         dtype=np.float32)
        img[inst > 0] += 0.7
        images.append(img)
        insts.append(inst)
    prop = FlowNetProposer.create(features=(8, 16), device=cuda, n_iter=50)
    clf = CellSegClassifier(5, encoder_cfg=ResNetConfig.tiny(), device=cuda)
    return prop, clf, images, insts


def _three_uses(call):
    """Three calls (the first use, the capture, a replay) and clones of each
    call's tensor outputs."""
    outs = []
    for _ in range(3):
        out = call()
        outs.append([t.clone() for t in (out if isinstance(out, tuple) else (out,))])
    torch.cuda.synchronize()
    return outs


@pytest.mark.gpu
def test_cell_and_transform_programs_replay_the_eager_first_use_bitwise(cuda):
    """Each new program (the proposer's net forward, follow_flows by method,
    _device_propose; classify_patches, classify_rois, roi_features; the
    DiffusionTransform at batch 1 and 2, the tiny SD components, f32): three
    uses, each replay's output equal to the first use's bit for bit, and one
    graph made."""
    from ldiffusion_tpu_torch.cell.classifier import extract_instance_boxes
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.segmentor.dataset_builder import DiffusionTransform

    prop, clf, images, insts = _tiny_cell(cuda)
    img = images[0]
    with torch.inference_mode():
        out = prop._net_out(torch.from_numpy(img).to(cuda))
        flows, prob = out[..., :2] / 5.0, torch.sigmoid(out[..., 2])
    _, boxes = extract_instance_boxes(insts[0])
    bb = clf.pad_boxes(boxes)
    patches = np.random.default_rng(22).normal(size=(20, 64, 64, 3)).astype(np.float32)
    comps = SDComponents.random(device=cuda)
    norm = np.random.default_rng(23).normal(size=(3, 64, 64, 3)).astype(np.float32)
    tf1, tf2 = DiffusionTransform(comps), DiffusionTransform(comps, batch_size=2)
    cases = [
        ("net", prop.programs["net"], lambda: prop._forward(img)),
        ("follow_squaring", prop.programs["follow_flows"],
         lambda: prop.follow(flows, prob, "squaring")),
        ("follow_euler", prop.programs["follow_flows"],
         lambda: prop.follow(flows, prob, "euler")),
        ("propose", prop.programs["propose"], lambda: prop._device_propose(img)),
        ("patch_logits", clf.programs["patch_logits"],
         lambda: clf.programs["patch_logits"](torch.from_numpy(
             np.concatenate([patches, np.zeros((12, 64, 64, 3), np.float32)]).astype(
                 np.float16)))),
        ("roi_logits", clf.programs["roi_logits"],
         lambda: clf.programs["roi_logits"](torch.from_numpy(img), torch.from_numpy(bb))),
        ("roi_features", clf.programs["roi_features"], lambda: clf.roi_features(img, bb)),
        ("transform_b1", tf1.program, lambda: torch.from_numpy(tf1(norm[:1]))),
        ("transform_b2", tf2.program, lambda: torch.from_numpy(tf2(norm[:2]))),
    ]
    for name, jit, call in cases:
        before = set(jit.programs)
        outs = _three_uses(call)
        (program,) = [p for k, p in jit.programs.items() if k not in before]
        assert program.graph is not None and program.replays == 2, name
        for replay in outs[1:]:
            for a, b in zip(replay, outs[0]):
                assert torch.equal(a, b), name
    # the classifier's and the proposer's user calls reach the same programs
    assert clf.classify_patches(patches).shape == (20,)
    assert prop.propose(img).shape == (64, 64)


@pytest.mark.gpu
def test_cached_features_do_not_alias(cuda):
    """``cache_features`` of two images of one bucket, twice: the second
    time both replay the program, and each entry still holds its own
    image's features (the eager function's, bit for bit), not the static
    output the next replay overwrites."""
    from ldiffusion_tpu_torch.cell.classifier import CellTrainer, extract_instance_boxes

    _, clf, images, insts = _tiny_cell(cuda)
    fixed = iter([])

    class Proposer:
        def propose(self, image):
            return next(fixed)

    clf.proposer = Proposer()
    tr = CellTrainer(clf)
    pairs = [(img, np.where(inst > 0, 1 + inst % 4, 0)) for img, inst in zip(images, insts)]
    fixed = iter(insts)
    tr.cache_features(pairs)  # the first use, then the capture
    fixed = iter(insts)
    cache = tr.cache_features(pairs)  # both replay
    (program,) = clf.programs["roi_features"].programs.values()
    assert program.replays == 3
    assert not torch.equal(cache[0][0], cache[1][0])
    with torch.inference_mode():
        for img, inst, (feats, _, _) in zip(images, insts, cache):
            _, boxes = extract_instance_boxes(inst)
            want = clf._roi_features(torch.from_numpy(img).to(cuda),
                                     torch.from_numpy(clf.pad_boxes(boxes)).to(cuda))
            assert torch.equal(feats, want)


def _cell_step_run(cuda, which: str, captured: bool, steps: int = 4):
    """``steps`` steps of a tiny flow-net or head trainer from the same
    weights: through ``step`` (eager, captured, replays) or ``step_fn``."""
    from ldiffusion_tpu_torch.cell.classifier import CellTrainer
    from ldiffusion_tpu_torch.cell.instance import FlowNetTrainer, masks_to_flows

    prop, clf, images, insts = _tiny_cell(cuda)
    rng = np.random.default_rng(24)
    if which == "flownet":
        tr, params = FlowNetTrainer(prop, lr=3e-3), list(prop.net.parameters())
        x = torch.from_numpy(np.stack(images)).to(cuda)
        y = torch.from_numpy(np.stack([masks_to_flows(m) for m in insts])).to(cuda)
        batches = [(x.roll(k, 1), y.roll(k, 1)) for k in range(steps)]
    else:
        tr, params = CellTrainer(clf, lr=1e-2), list(clf.head.parameters())
        batches = [(torch.from_numpy(rng.normal(size=(32, 64, 2, 2)).astype(np.float32)).to(cuda),
                    torch.from_numpy(rng.integers(0, 5, 32)).to(cuda),
                    torch.from_numpy((np.arange(32) < 20 + k).astype(np.float32)).to(cuda))
                   for k in range(steps)]
    losses = [tr.step(*b) if captured else float(tr.step_fn(*b)) for b in batches]
    st = tr.opt.state
    return tr, {"losses": [torch.tensor(losses)], "params": [p.detach().clone() for p in params],
                "exp_avg": [st[p]["exp_avg"].clone() for p in params],
                "exp_avg_sq": [st[p]["exp_avg_sq"].clone() for p in params]}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["flownet", "head"])
def test_captured_cell_steps_match_the_eager_route(cuda, monkeypatch, which):
    """The flow-net and the head trainer (cuDNN held to its deterministic
    algorithms): 4 steps through their program against the step function
    called eagerly from the same weights and batches."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr, captured = _cell_step_run(cuda, which, True)
    _, eager = _cell_step_run(cuda, which, False)
    _, eager_again = _cell_step_run(cuda, which, False)
    _held_to_eager(captured, eager, eager_again)
    (program,) = tr.program.programs.values()
    assert program.graph is not None and program.replays == 3


@pytest.mark.gpu
@pytest.mark.parametrize("owner", ["proposer", "classifier", "transform", "head_step"])
def test_a_cell_program_capture_that_fails_raises(cuda, monkeypatch, owner):
    """No fallback for the new programs either: with graph capture refused
    (before CUDA is asked to capture), the second use raises and the program
    holds no graph; the first use ran eagerly."""
    from ldiffusion_tpu_torch.cell.classifier import CellTrainer
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.segmentor.dataset_builder import DiffusionTransform

    prop, clf, images, insts = _tiny_cell(cuda)
    if owner == "proposer":
        jit, call = prop.programs["propose"], lambda: prop._device_propose(images[0])
    elif owner == "classifier":
        bb = clf.pad_boxes([(8, 8, 20, 20)])
        jit, call = clf.programs["roi_logits"], lambda: clf.classify_rois(images[0], bb[:1])
    elif owner == "transform":
        tf = DiffusionTransform(SDComponents.random(device=cuda))
        norm = np.zeros((1, 64, 64, 3), np.float32)
        jit, call = tf.program, lambda: tf(norm)
    else:
        tr = CellTrainer(clf)
        batch = (torch.zeros(32, 64, 2, 2, device=cuda),
                 torch.zeros(32, dtype=torch.int64, device=cuda), torch.ones(32, device=cuda))
        jit, call = tr.program, lambda: tr.step(*batch)
    call()  # the first use: eager

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        call()
    (program,) = jit.programs.values()
    assert program.graph is None and program.replays == 0
