"""GroupNorm's routing between its two CUDA routes, on the CPU.

``gn_route`` sends a call to the resident route (csrc/groupnorm_sm90.cu
``gn_resident``: one cluster launch, x held in shared memory) where x takes
16-byte accesses, the call is at most ``RESIDENT_MAX_BYTES`` and
``gn_resident_config`` (the mirror of the C ``resident_config``) finds a
slice and cluster that fit; the rest streams (``gn_stream_stats`` +
``gn_stream_apply``), C·itemsize not a multiple of 16 and x off the 16-byte
grid in the scalar variant. The shapes here are every GroupNorm call of a
1024² ROI and of a 512² training step at SD-v1.5 width, recorded by running
the UNet and the VAE on ``device="meta"``. The kernels themselves run only
on a card (``test_torch_port_kernels.py``, which also holds the mirror
against the library's own choice).

Tolerances: ``plain_groupnorm_silu`` against the XLA formulation in f32,
1e-5 (the same arithmetic summed in another order); against the Pallas
kernels in interpret mode, 2e-4 as ``tests/test_torch_port_ops.py`` (the
kernels sum through matmuls and in blocks).
"""
import collections
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldiffusion_tpu.ops import groupnorm as jgn
from ldiffusion_tpu_torch.models import layers
from ldiffusion_tpu_torch.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ldiffusion_tpu_torch.ops import attention as tatt
from ldiffusion_tpu_torch.ops import groupnorm as tgn
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

SMEM_PER_BLOCK = 232448
MAX_CLUSTER = 16
XLA_TOL = 1e-5
INTERPRET_TOL = 2e-4


@pytest.fixture(autouse=True)
def restore_modes():
    yield
    jgn.set_groupnorm_mode("auto")


@functools.cache
def _call_shapes():
    """{path: {"unet": Counter, "vae": Counter}} of (B, H, W, C, G) GroupNorm
    calls: path "roi" (1024² image: VAE encode, UNet at 128², VAE decode) and
    "step" (512² image, one timestep: UNet at 64², VAE decode, and the
    encode)."""
    log = collections.Counter()

    def record(self, x):
        b, c, h, w = x.shape
        log[(b, h, w, c, self.groups)] += 1
        return x

    def attention(q, k, v, scale=None):
        return tatt.plain_attention(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)

    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(layers.FusedGroupNormSiLU, "forward", record)
        mp.setattr(layers, "dot_product_attention", attention)
        with torch.device("meta"), torch.no_grad():
            unet = UNet2DCondition(UNet2DConditionConfig.sd15())
            vae = AutoencoderKL(VAEConfig.sd15())
            for path, size in (("roi", 1024), ("step", 512)):
                log.clear()
                latents = vae.encode_mean(torch.empty(1, 3, size, size))
                vae_calls = collections.Counter(log)
                log.clear()
                eps = unet(latents, 1, torch.empty(1, 5, 768))
                unet_calls = collections.Counter(log)
                log.clear()
                vae.decode(eps)
                out[path] = {"unet": unet_calls, "vae": vae_calls + log}
    finally:
        mp.undo()
    return out


def _all_calls(path):
    calls = _call_shapes()[path]
    return calls["unet"] + calls["vae"]


@pytest.mark.parametrize("path", ["roi", "step"])
def test_every_call_shape_has_a_route_and_a_config_that_fits(path):
    calls = _all_calls(path)
    assert sum(calls.values()) == 113  # the GroupNorm layers of encode, UNet, decode
    for (b, h, w, c, g) in calls:
        route = tgn.gn_route(b, h * w, c, g, torch.bfloat16, True)
        cfg = tgn.gn_resident_config(b, h * w, c, g, torch.bfloat16)
        assert route in tgn.ROUTES
        if route == "resident":
            assert cfg["slice_bytes"] % 16 == 0 and cfg["slice_bytes"] >= tgn.MIN_SLICE_BYTES
            assert cfg["smem"] <= SMEM_PER_BLOCK
            assert cfg["cluster"] <= MAX_CLUSTER
            assert cfg["cluster"] * cfg["rows"] >= h * w
            assert cfg["boxes"] * cfg["box_rows"] >= cfg["rows"]
            assert cfg["box_rows"] % 8 == 0 and cfg["box_rows"] <= 256
            assert (cfg["groups"] * (c // g)) * 2 == cfg["slice_bytes"]


def test_every_unet_map_of_the_512_step_is_resident():
    unet = _call_shapes()["step"]["unet"]
    assert max(h for _, h, _, _, _ in unet) == 64  # 512² images → 64² latents
    for (b, h, w, c, g) in unet:
        assert tgn.gn_route(b, h * w, c, g, torch.bfloat16, True) == "resident", (h, c)
    assert tgn.gn_route(1, 256, 1280, 32, torch.bfloat16, True) == "resident"


@pytest.mark.parametrize("path", ["roi", "step"])
def test_every_call_shape_has_a_backward_route_and_a_config_that_fits(path):
    """The backward's resident route holds x and dy: 200 KB of the two a CTA."""
    for (b, h, w, c, g) in _all_calls(path):
        route = tgn.gn_route(b, h * w, c, g, torch.bfloat16, True, backward=True)
        cfg = tgn.gn_resident_config(b, h * w, c, g, torch.bfloat16, backward=True)
        assert route == ("resident" if cfg is not None and b * h * w * c * 2 <=
                         tgn.RESIDENT_MAX_BYTES else "stream")
        if route == "resident":
            assert cfg["smem"] <= SMEM_PER_BLOCK and cfg["cluster"] <= MAX_CLUSTER
            assert cfg["cluster"] * cfg["rows"] >= h * w
            assert 2 * cfg["boxes"] * cfg["box_rows"] * cfg["slice_bytes"] <= tgn._DATA_MAX
            forward = tgn.gn_resident_config(b, h * w, c, g, torch.bfloat16)
            assert cfg["cluster"] >= forward["cluster"], (h, c)


# stage 1's maps: the 512² UNet's (64² latents), the 512² VAE decode's, and
# the 64²-image batch-8 step's UNet (8² latents) and VAE decode
@pytest.mark.parametrize("shape,route", [
    ((1, 64, 64, 320), "resident"), ((1, 16, 16, 1280), "resident"),
    ((1, 256, 256, 512), "stream"), ((1, 512, 512, 128), "stream"),
    ((8, 8, 8, 320), "resident"), ((8, 64, 64, 128), "resident")])
def test_stage1_maps_take_their_backward_route(shape, route):
    b, h, w, c = shape
    assert tgn.gn_route(b, h * w, c, 32, torch.bfloat16, True, backward=True) == route
    assert tgn.gn_route(b, h * w, c, 32, torch.bfloat16, False, backward=True) == "stream"


@pytest.mark.parametrize("shape", [(1, 128, 128, 960), (1, 1024, 1024, 128),
                                   (1, 512, 512, 256)])
def test_the_widest_roi_map_and_the_vae_maps_stream(shape):
    b, h, w, c = shape
    assert (b, h, w, c, 32) in _all_calls("roi")
    assert tgn.gn_route(b, h * w, c, 32, torch.bfloat16, True) == "stream"


@pytest.mark.parametrize("c,groups,dtype,aligned,vectorised", [
    # C·itemsize not a multiple of 16: the scalar variant, which only streams
    (36, 4, torch.bfloat16, True, False), (100, 4, torch.bfloat16, True, False),
    # x off the 16-byte grid: the scalar variant too
    (96, 8, torch.bfloat16, False, False), (96, 8, torch.float32, False, False),
    # 96 channels fill whole 16-byte vectors (192 / 384 bytes) when aligned
    (96, 8, torch.bfloat16, True, True), (36, 4, torch.float32, True, True)])
def test_odd_channel_counts_take_the_scalar_variant(c, groups, dtype, aligned, vectorised):
    assert tgn.vectorised(c, dtype, aligned) == vectorised
    route = tgn.gn_route(1, 81, c, groups, dtype, aligned)
    assert route == ("resident" if vectorised else "stream")
    if not vectorised:
        n_chunks, rows = tgn.stream_chunks(1, 81, c, dtype, False)
        assert n_chunks * rows >= 81 and (n_chunks - 1) * rows < 81


@pytest.mark.parametrize("shape,groups,slice_groups,cluster", [
    # 40-channel groups (80 B): two groups a slice (160 B), 16 slices x 8 CTAs
    ((1, 16, 16, 1280), 32, 2, 8),
    # 10-channel groups (20 B): 8 groups a slice (160 B), 4 slices x 16 CTAs
    ((1, 128, 128, 320), 32, 8, 16),
    # 30-channel groups (60 B): 4 groups (240 B), 8 slices x 16 CTAs
    ((1, 64, 64, 960), 32, 4, 16),
    # 2-channel groups (4 B): the whole 128-byte row; 8 rows a CTA at least
    ((1, 8, 8, 64), 32, 32, 8)])
def test_resident_config_slices_and_clusters(shape, groups, slice_groups, cluster):
    b, h, w, c = shape
    cfg = tgn.gn_resident_config(b, h * w, c, groups, torch.bfloat16)
    assert (cfg["groups"], cfg["cluster"]) == (slice_groups, cluster)


def test_resident_config_refuses_what_does_not_fit():
    # 128²×960: 8 slices of 240 B over 16 CTAs would need 245,760 B of x a CTA
    assert tgn.gn_resident_config(1, 128 * 128, 960, 32, torch.bfloat16) is None
    assert tgn.gn_resident_config(1, 81, 36, 4, torch.bfloat16) is None  # 72-byte rows
    assert tgn.gn_resident_config(1, 81, 64, 3, torch.bfloat16) is None  # C % G != 0
    # 256²×256: 64-byte slices do not fit, 32-byte ones do
    assert tgn.gn_resident_config(1, 256 * 256, 256, 32, torch.bfloat16) is None
    assert tgn.gn_resident_config(1, 256 * 256, 256, 32, torch.bfloat16, 32)["cluster"] == 16


@pytest.mark.parametrize("b,hw,c,vec", [(1, 1024 * 1024, 128, True), (1, 90000, 128, True),
                                        (3, 4096, 256, True), (2, 63, 96, False),
                                        (1, 81, 36, False), (1, 1, 2560, True)])
def test_stream_chunks_cover_every_row_once(b, hw, c, vec):
    n_chunks, rows = tgn.stream_chunks(b, hw, c, torch.bfloat16, vec)
    assert n_chunks * rows >= hw and (n_chunks - 1) * rows < hw
    assert b * n_chunks <= max(tgn._STREAM_CTAS, b)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, groups, eps, silu):
    return tgn.plain_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), groups, eps, silu).numpy()


@pytest.mark.parametrize("silu", [True, False])
def test_plain_matches_xla_at_a_resident_width(silu):
    """B = 3, C = 1920 (the ROI's 64²×1920 width, two groups a slice)."""
    x, scale, bias = _inputs(30, (3, 8, 8, 1920))
    ref = jgn._xla_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                  1e-5, silu)
    np.testing.assert_allclose(_port(x, scale, bias, 32, 1e-5, silu), np.asarray(ref),
                               atol=XLA_TOL, rtol=XLA_TOL)


@pytest.mark.parametrize("silu", [True, False])
def test_plain_matches_pallas_k3_interpret_at_a_resident_width(silu):
    x, scale, bias = _inputs(31, (3, 8, 8, 1920))
    jgn.set_groupnorm_mode("pallas_interpret")
    ref = jgn.groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             groups=32, eps=1e-6, silu=silu)
    np.testing.assert_allclose(_port(x, scale, bias, 32, 1e-6, silu), np.asarray(ref),
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


def test_plain_matches_pallas_k4_interpret_at_a_resident_width():
    """The streamed pair (stats chunks of 512 rows, then apply) at B = 3."""
    x, scale, bias = _inputs(32, (3, 16, 32, 1920))
    ref = jgn._pallas_groupnorm_silu_chunked(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias), 32, 1e-5, True,
                                             interpret=True)
    np.testing.assert_allclose(_port(x, scale, bias, 32, 1e-5, True), np.asarray(ref),
                               atol=INTERPRET_TOL, rtol=INTERPRET_TOL)


def test_cpu_tensors_count_no_route():
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    before = dict(tgn.groupnorm_silu.launches_by_route)
    launches = tgn.groupnorm_silu.launches
    tgn.groupnorm_silu(x, torch.ones(64), torch.zeros(64), 32)
    assert tgn.groupnorm_silu.launches_by_route == before
    assert tgn.groupnorm_silu.launches == launches
    assert set(before) == set(tgn.ROUTES)
