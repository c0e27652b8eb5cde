"""The trainer variants, optimizers, losses and sampling modes of the port
against the JAX package's, on the CPU in float32.

Tolerances (float32 on both sides; only the order of sums differs):
- recipes, schedules, mirror configurations, sampler batches: exact;
- losses, plain and masked: 1e-6 relative (the top-k mean selects the same
  pixels: it is the mean of the k largest values of the same per-pixel
  losses);
- two optimizer steps (SGD, Adam, Adan) on the same parameters and
  gradients: within 5e-5 of each tensor's largest value, the stage-2 step
  tolerance of ``test_torch_port_seg_train``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data.patches import PatchSampler as JSampler
from ldiffusion_tpu.losses import dice as jdice
from ldiffusion_tpu.segmentor import preprocess as jpre
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor import variants as jvar
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.patches import PatchSampler as TSampler
from ldiffusion_tpu_torch.losses import dice as tdice
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.segmentor import preprocess as tpre
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor import variants as tvar
from ldiffusion_tpu_torch.segmentor.planner import SegPlan

LOSS_TOL = 1e-6
STEP_TOL = 5e-5
PLAN = dict(patch_size=(16, 16), batch_size=2, features_per_stage=(4, 8), strides=(1, 2),
            n_conv_per_stage=2, num_classes=3, in_channels=3, normalization="zscore_image",
            intensity_properties={}, median_shape=(16, 16), batch_dice=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _asdict(v):
    d = dataclasses.asdict(v)
    return {k: (dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x)
            for k, x in d.items()}


# ---------------------------------------------------------------------------
# recipes
# ---------------------------------------------------------------------------

def test_there_are_51_names_and_they_are_the_jax_packages():
    assert tvar.KNOWN_VARIANT_NAMES == jvar.KNOWN_VARIANT_NAMES
    assert len(tvar.KNOWN_VARIANT_NAMES) == 51


@pytest.mark.parametrize("name", tvar.KNOWN_VARIANT_NAMES)
def test_every_name_resolves_to_the_jax_recipe(name):
    base = dict(num_epochs=20, iters_per_epoch=3)
    t = tvar.get_variant(name, base=SegmentorTrainConfig(**base))
    j = jvar.get_variant(name, base=JConfig(**base))
    assert _asdict(t) == _asdict(j)
    for ep in (0, 7, 19):
        assert tvar.lr_at_epoch(t, ep, 20) == jvar.lr_at_epoch(j, ep, 20)
    for nd in (2, 3):
        assert tvar.inference_mirror_config(t, nd) == jvar.inference_mirror_config(j, nd)


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown trainer variant"):
        tvar.get_variant("nnUNetTrainerDA6")
    assert tvar.inference_mirror_config(None, 2) == jvar.inference_mirror_config(None, 2)


# ---------------------------------------------------------------------------
# optimizers: the trainer's update against the JAX optax chain
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", ["nnUNetTrainer", "nnUNetTrainerAdam", "nnUNetTrainerAdan",
                                  "nnUNetTrainerAdan1en1"])
def test_two_optimizer_steps_match_the_jax_chain(name, tmp_path):
    """Two steps with the variant's optimizer after clip_grad_norm_(12) (the
    first step's gradients are large enough to be clipped), with weight decay
    0.1 so the coupled and decoupled forms differ visibly."""
    base = dict(compute_dtype="float32", weight_decay=0.1)
    jv = jvar.get_variant(name, base=JConfig(**base))
    tv = tvar.get_variant(name, base=SegmentorTrainConfig(**base))
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), jv.config, mesh, output_dir=str(tmp_path / "j"),
                                    variant=jv)
    params = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    cfg = SegPlan(**PLAN).network_config()
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), tv.config, output_dir=str(tmp_path / "t"),
                                   variant=tv, device="cpu")
    tr.net.load_state_dict(dynunet_from_flax(params, cfg))
    rng = np.random.default_rng(0)
    opt_state = jtr.state.opt_state
    for step, scale in enumerate((5.0, 0.3)):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), params)
        lr = jv.config.initial_lr * (0.9 if step else 1.0)
        updates, opt_state = jtr.tx.update(grads, jtrainer._set_lr(opt_state, lr), params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        tgrads = dynunet_from_flax(grads, cfg)
        for k, p in tr.net.named_parameters():
            p.grad = tgrads[k].clone()
        tr.apply_update(lr)
        want = dynunet_from_flax(params, cfg)
        for k, p in tr.net.named_parameters():
            err = float((p.detach() - want[k]).abs().max()) / float(want[k].abs().max())
            assert err <= STEP_TOL, (step, k, err)
    assert tr.opt_name == jv.optimizer


# ---------------------------------------------------------------------------
# losses, plain and masked
# ---------------------------------------------------------------------------

def _loss_inputs(seed, c=4, masked_share=0.0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 12, 10, c)) * 2).astype(np.float32)
    tgt = rng.integers(0, c, (2, 12, 10)).astype(np.int32)
    regions = (rng.random((2, 12, 10, c)) < 0.4).astype(np.float32)
    mask = (rng.random((2, 12, 10)) >= masked_share).astype(np.float32)
    return logits, tgt, regions, mask


def _t(x, channels=True):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2) if channels else t


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


PLAIN_LOSSES = [
    ("soft_dice", lambda m, lg, t, mk, bd: m.soft_dice_loss(lg, t, loss_mask=mk, batch_dice=bd)),
    ("soft_dice_noSmooth", lambda m, lg, t, mk, bd: m.soft_dice_loss(lg, t, loss_mask=mk,
                                                                     batch_dice=bd, smooth=0.0)),
    ("robust_ce", lambda m, lg, t, mk, bd: m.robust_cross_entropy(lg, t, loss_mask=mk)),
    ("topk10", lambda m, lg, t, mk, bd: m.topk_cross_entropy(lg, t, loss_mask=mk)),
    ("topk10_ls01", lambda m, lg, t, mk, bd: m.topk_cross_entropy(lg, t, label_smoothing=0.1,
                                                                  loss_mask=mk)),
    ("focal", lambda m, lg, t, mk, bd: m.focal_loss(lg, t, loss_mask=mk)),
    ("dc_and_ce", lambda m, lg, t, mk, bd: m.dc_and_ce_loss(lg, t, loss_mask=mk, batch_dice=bd)),
    ("dc_and_focal", lambda m, lg, t, mk, bd: m.dc_and_focal_loss(lg, t, loss_mask=mk,
                                                                  batch_dice=bd)),
]
SIGMOID_LOSSES = [
    ("bce", lambda m, lg, r, mk, bd: m.binary_cross_entropy_with_logits(lg, r, loss_mask=mk)),
    ("sigmoid_dice", lambda m, lg, r, mk, bd: m.soft_dice_loss_sigmoid(lg, r, loss_mask=mk,
                                                                       batch_dice=bd)),
    ("dc_and_bce", lambda m, lg, r, mk, bd: m.dc_and_bce_loss(lg, r, loss_mask=mk,
                                                              batch_dice=bd)),
    ("sigmoid_focal", lambda m, lg, r, mk, bd: m.sigmoid_focal_loss(lg, r, loss_mask=mk)),
    ("dc_and_focal_sigmoid", lambda m, lg, r, mk, bd: m.dc_and_focal_sigmoid_loss(
        lg, r, loss_mask=mk, batch_dice=bd)),
]


# masked share: none, half, and 97% (fewer unmasked pixels than the top 10%:
# the masked zeros enter the top k, as in the JAX package)
@pytest.mark.parametrize("masked_share", [None, 0.5, 0.97])
@pytest.mark.parametrize("batch_dice", [True, False])
def test_every_loss_matches_jax(masked_share, batch_dice):
    logits, tgt, regions, mask = _loss_inputs(3, masked_share=masked_share or 0.0)
    jm = None if masked_share is None else jnp.asarray(mask)
    tm = None if masked_share is None else torch.from_numpy(mask)
    for name, fn in PLAIN_LOSSES:
        a = fn(tdice, _t(logits), _t(tgt, False), tm, batch_dice)
        b = fn(jdice, jnp.asarray(logits), jnp.asarray(tgt), jm, batch_dice)
        assert _rel(a, b) <= LOSS_TOL, name
    for name, fn in SIGMOID_LOSSES:
        a = fn(tdice, _t(logits), _t(regions), tm, batch_dice)
        b = fn(jdice, jnp.asarray(logits), jnp.asarray(regions), jm, batch_dice)
        assert _rel(a, b) <= LOSS_TOL, name


def test_topk_under_a_mask_counts_the_same_pixels():
    """k = int(N·10/100) of all N pixels, masked pixels zeroed first: with 97%
    masked, the unmasked losses are all in the top k and the mean divides by
    k, not by the unmasked count."""
    logits, tgt, _, mask = _loss_inputs(5, masked_share=0.97)
    nll = -torch.log_softmax(_t(logits), 1).gather(1, _t(tgt, False).long()[:, None])[:, 0]
    k = int(nll.numel() * 10 / 100)
    assert mask.sum() < k
    want = float((nll * torch.from_numpy(mask)).sum() / k)
    got = tdice.topk_cross_entropy(_t(logits), _t(tgt, False), loss_mask=torch.from_numpy(mask))
    assert _rel(got, want) <= LOSS_TOL
    assert _rel(got, jdice.topk_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                              loss_mask=jnp.asarray(mask))) <= LOSS_TOL


# ---------------------------------------------------------------------------
# probabilistic oversampling
# ---------------------------------------------------------------------------

def _cases(n=3, size=40, seed=0):
    rng = np.random.default_rng(seed)
    images = [np.kron(rng.random((size // 8, size // 8, 3)), np.ones((8, 8, 1)))
              .astype(np.float32) + 0.05 for _ in range(n)]
    labels = [np.kron(rng.integers(0, 4, (size // 8, size // 8)) * (rng.random() < 0.9),
                      np.ones((8, 8), np.int64)).astype(np.int32) for _ in range(n)]
    return images, labels


@pytest.mark.parametrize("oversample", [0.33, 0.1, 1.0])
def test_probabilistic_oversampling_batches_equal_jax(oversample):
    images, labels = _cases()
    ds = tpre.PreprocessedDataset.build(images, labels, 4)
    jds = jpre.PreprocessedDataset.build(images, labels, 4)
    port = iter(TSampler(ds, (24, 24), 3, oversample, seed=11,
                         probabilistic_oversampling=True))
    ref = iter(JSampler(jds, (24, 24), 3, oversample, seed=11,
                        probabilistic_oversampling=True))
    for _ in range(6):
        (d, s), (jd, js) = next(port), next(ref)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bs,p", [(2, 0.33), (3, 0.33), (5, 0.2), (1, 0.5)])
def test_effective_oversample_percent_matches_jax(bs, p):
    assert TSampler.effective_oversample_percent(bs, p) == \
        JSampler.effective_oversample_percent(bs, p)
