"""The port's stage-1 losses and their pieces against the JAX package's.

Everything runs on the CPU in f32 on the same numpy inputs. Tolerances:
``resize_bilinear`` takes the same taps as ``jax.image.resize(...,
antialias=False)``, but the two compute the sample positions in f32 by other
formulas, so a weight differs by up to ~1e-6 per output index: 5e-5 on
unit-normal inputs (values within ±5); ``rgb_to_gray`` is the same weighted
sum (1e-6); VGG's sixteen convolutions sum in another order (1e-4 of the
features' scale); the contrastive loss takes the JAX package's own anchor,
positive and negative indices, drawn from its keys, and sums the same terms
(1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.losses import infonce as jinfo
from ldiffusion_tpu.models.vgg import VGG19Features as JVGG
from ldiffusion_tpu.ops.resize import resize_bilinear as j_resize
from ldiffusion_tpu.ops.resize import rgb_to_gray as j_gray
from ldiffusion_tpu_torch.losses.infonce import (
    ContrastIndices,
    InfoNceLoss,
    contrastive_loss,
    sample_contrast_indices,
)
from ldiffusion_tpu_torch.models.vgg import VGG19Features, convert_vgg19, vgg_from_flax
from ldiffusion_tpu_torch.ops.resize import resize_bilinear, rgb_to_gray
from torch_port_common import jax_contrast_indices
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

EXACT_TOL = 1e-6
RESIZE_TOL = 5e-5
VGG_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.mark.parametrize("src,dst", [(512, 64), (64, 224), (64, 64), (40, 56), (37, 16)])
def test_resize_bilinear_matches_jax_without_antialias(src, dst):
    x = np.random.default_rng(0).normal(size=(2, src, src + 3, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), (dst, dst + 1)))
    got = resize_bilinear(torch.from_numpy(x), (dst, dst + 1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


def test_resize_bilinear_channels_first_is_the_same_resize():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 32, 48)).astype(np.float32))
    nhwc = resize_bilinear(x.permute(0, 2, 3, 1), (20, 10))
    assert torch.equal(resize_bilinear(x, (20, 10), channel_last=False),
                       nhwc.permute(0, 3, 1, 2))


def test_rgb_to_gray_matches_jax():
    x = np.random.default_rng(2).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(rgb_to_gray(torch.from_numpy(x)).numpy(),
                               np.asarray(j_gray(jnp.asarray(x))), atol=EXACT_TOL)


@pytest.fixture(scope="module")
def jax_vgg_params():
    return jax.jit(JVGG().init)(jax.random.key(7), jnp.zeros((1, 64, 64, 3)))["params"]


def _port_vgg(params):
    vgg = VGG19Features()
    vgg.load_state_dict(vgg_from_flax(params))
    return vgg.requires_grad_(False).eval()


def test_vgg_from_flax_matches_jax(jax_vgg_params):
    x = np.random.default_rng(3).normal(size=(2, 96, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JVGG().apply)({"params": jax_vgg_params}, jnp.asarray(x)))
    got = _port_vgg(jax_vgg_params)(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 3, 2, 512)
    np.testing.assert_allclose(got, want, atol=VGG_TOL * np.abs(want).max())


def test_convert_vgg19_takes_a_torchvision_state_dict(jax_vgg_params):
    sd = dict(vgg_from_flax(jax_vgg_params))
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # dropped: not a feature layer
    vgg = VGG19Features()
    vgg.load_state_dict(convert_vgg19(sd))
    assert torch.equal(vgg.features[34].weight, sd["features.34.weight"])


def test_content_loss_matches_jax(jax_vgg_params):
    rng = np.random.default_rng(4)
    original, generated = (rng.normal(size=(2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    jloss = jinfo.InfoNceLoss(vgg=JVGG(), vgg_params=jax_vgg_params)
    want = float(jloss.content_loss(jnp.asarray(original), jnp.asarray(generated)))
    loss = InfoNceLoss(vgg=_port_vgg(jax_vgg_params))
    got = float(loss.content_loss(torch.from_numpy(original), torch.from_numpy(generated)))
    assert got == pytest.approx(want, rel=VGG_TOL)


def test_create_without_weights_warns_and_freezes():
    with pytest.warns(UserWarning, match="RANDOM frozen VGG"):
        loss = InfoNceLoss.create(device="cpu", num_anchors=8, num_negatives=16)
    assert not loss.pretrained_vgg
    assert not any(p.requires_grad for p in loss.vgg.parameters())


def to_port_indices(idx) -> ContrastIndices:
    return ContrastIndices(*(torch.from_numpy(np.asarray(a)) for a in idx))


def _labels(b=2, size=32):
    """Classes 0 (bottom right), 1 (top half), 2 (bottom left); image 1 also
    has a 16-pixel class 3."""
    lab = np.zeros((b, size, size), np.int32)
    lab[:, : size // 2] = 1
    lab[:, size // 2:, : size // 2] = 2
    lab[1, :4, :4] = 3
    return lab


@pytest.mark.parametrize("num_classes", [None, 5])
def test_contrastive_loss_with_jax_indices_matches_jax(num_classes):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    labels = _labels()
    key = jax.random.key(11)
    want = float(jinfo.contrastive_loss(jnp.asarray(feats), jnp.asarray(labels), key, 0.5, 64,
                                        16, num_classes))
    idx = jax_contrast_indices(labels, key, 64, 16, num_classes)
    got = float(contrastive_loss(torch.from_numpy(feats), to_port_indices(idx), 0.5))
    assert got == pytest.approx(want, rel=LOSS_TOL, abs=LOSS_TOL)


def test_contrastive_loss_is_zero_without_valid_anchors():
    feats = torch.randn(1, 4, 4, 3)
    idx = ContrastIndices(torch.zeros(1, 2, dtype=torch.long), torch.ones(1, 2, dtype=torch.long),
                          torch.zeros(1, 2, 3, dtype=torch.long), torch.zeros(1, 2, dtype=bool))
    assert float(contrastive_loss(feats, idx)) == 0.0


def test_sampler_follows_the_reference_rules():
    """Pinned anchors one per present class, positives of the anchor's class
    but not the anchor, negatives of other classes, the eligibility rule."""
    labels = torch.from_numpy(_labels())
    gen = torch.Generator().manual_seed(0)
    idx = sample_contrast_indices(labels, gen, num_negatives=64, num_anchors=16, num_classes=5)
    flat = labels.reshape(2, -1)
    for b in range(2):
        lab_a = flat[b][idx.anchor[b]]
        assert torch.equal(lab_a[:4][torch.isin(torch.arange(4), flat[b])],
                           torch.arange(4)[torch.isin(torch.arange(4), flat[b])])
        assert torch.equal(flat[b][idx.positive[b]], lab_a)
        assert not bool((idx.positive[b] == idx.anchor[b]).any())
        assert bool((flat[b][idx.negatives[b]] != lab_a[:, None]).all())
        counts = torch.bincount(flat[b], minlength=5)
        want = (counts[lab_a] > 1) & (flat.shape[1] - counts[lab_a] > 64)
        want[:5] &= torch.isin(torch.arange(5), flat[b])
        assert torch.equal(idx.valid[b], want)
    assert not bool(idx.valid[0, 3]) and not bool(idx.valid[:, 4].any())  # absent classes
    again = sample_contrast_indices(labels, torch.Generator().manual_seed(0), 64, 16, 5)
    assert all(torch.equal(a, b) for a, b in zip(idx, again))
    with pytest.raises(ValueError):
        sample_contrast_indices(labels, gen, num_negatives=4, num_anchors=5, num_classes=5)
