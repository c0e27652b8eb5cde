"""The label regimes of the port against the JAX package's, on the CPU in
float32: plain labels, plain labels with an ignore label, regions (sigmoid
heads painted in ``regions_class_order``) and regions with an ignore label.
The label manager's conversions, the trainer's training loss and validation
counts under each regime, the predictor's masks, the npz of probabilities,
the region/ignore ``summary.json`` and the postprocessing decision.

Tolerances (float32 on both sides; only the order of sums differs):
- the label manager (the same float64 numpy code): exact;
- training loss: 1e-6 relative; validation tp/fp/fn: exact (0/1 counts);
- masks of the two predictors (f32, same weights): equal on >= 99.5% of
  pixels, the slice tolerance of ``test_torch_port_api``;
- npz: the same float16 array; ``summary.json``: 1e-12; postprocessing: equal.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data.augment import AugmentConfig as JAugment
from ldiffusion_tpu.evaluate import compute_metrics_on_folder as j_metrics
from ldiffusion_tpu.segmentor import export as jexport
from ldiffusion_tpu.segmentor import label_manager as jlabel
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor import variants as jvar
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu.segmentor.postprocess import determine_postprocessing as j_pp
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.augment import AugmentConfig
from ldiffusion_tpu_torch.evaluate import compute_metrics_on_folder as t_metrics
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.segmentor import export as texport
from ldiffusion_tpu_torch.segmentor import label_manager as tlabel
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor import variants as tvar
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.postprocess import determine_postprocessing as t_pp
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor

LOSS_TOL = 1e-6
MASK_AGREEMENT = 0.995
NO_DA = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
             p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)

# dataset.json label dicts; labels 0-3 in the images, 4 the ignore label
REGIMES = {
    "plain": ({"background": 0, "a": 1, "b": 2, "c": 3}, None),
    "ignore": ({"background": 0, "a": 1, "b": 2, "c": 3, "ignore": 4}, None),
    "regions": ({"background": 0, "abc": (1, 2, 3), "ab": (1, 2), "a": (1,)}, [3, 2, 1]),
    "regions_ignore": ({"background": 0, "abc": (1, 2, 3), "bc": (2, 3), "c": (3,),
                        "ignore": 4}, [1, 2, 3]),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lms(regime):
    labels, order = REGIMES[regime]
    return tlabel.LabelManager(dict(labels), order), jlabel.LabelManager(dict(labels), order)


def _plan(heads, cls=SegPlan):
    return cls(patch_size=(16, 16), batch_size=2, features_per_stage=(4, 8), strides=(1, 2),
               n_conv_per_stage=2, num_classes=heads, in_channels=3,
               normalization="zscore_image", intensity_properties={}, median_shape=(24, 24),
               batch_dice=True)


def _labels(rng, n, size, ignore: bool):
    lab = np.stack([np.kron(rng.integers(0, 4, (size // 4, size // 4)), np.ones((4, 4)))
                    for _ in range(n)]).astype(np.int32)
    if ignore:
        lab[:, :3] = 4
    return lab


@pytest.mark.parametrize("regime", list(REGIMES))
def test_label_manager_matches_jax(regime):
    t, j = _lms(regime)
    for attr in ("has_regions", "has_ignore_label", "ignore_label", "all_labels",
                 "foreground_labels", "num_segmentation_heads", "regions",
                 "labels_or_regions_for_eval"):
        assert getattr(t, attr) == getattr(j, attr), attr
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(9, 7, t.num_segmentation_heads)) * 3).astype(np.float32)
    np.testing.assert_array_equal(t.apply_inference_nonlin(logits),
                                  j.apply_inference_nonlin(logits))
    np.testing.assert_array_equal(t.convert_logits_to_segmentation(logits),
                                  j.convert_logits_to_segmentation(logits))
    seg = _labels(rng, 1, 8, t.has_ignore_label)[0]
    for a, b in zip(t.seg_to_training_target(seg), j.seg_to_training_target(seg)):
        np.testing.assert_array_equal(a, b)
    dj = {"labels": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in REGIMES[regime][0].items()}}
    if REGIMES[regime][1]:
        dj["regions_class_order"] = REGIMES[regime][1]
    assert tlabel.label_manager_from_dataset_json(dj).num_segmentation_heads == \
        t.num_segmentation_heads


@pytest.mark.parametrize("regime,name", [("ignore", "nnUNetTrainer"),
                                         ("ignore", "nnUNetTrainerTopk10Loss"),
                                         ("ignore", "nnUNetTrainerDiceLoss"),
                                         ("regions", "nnUNetTrainer"),
                                         ("regions_ignore", "nnUNetTrainerCELoss")])
def test_training_loss_and_validation_counts_match_jax(regime, name, tmp_path):
    """The trainer's deep-supervision loss (region maps and loss masks from the
    lookup tables, the variant's loss, or DC + sigmoid focal for regions) and
    its validation tp/fp/fn, on the same weights and labels."""
    tlm, jlm = _lms(regime)
    heads = tlm.num_segmentation_heads
    cfg = dict(compute_dtype="float32")
    jv = jvar.get_variant(name, base=JConfig(**cfg))
    tv = tvar.get_variant(name, base=SegmentorTrainConfig(**cfg))
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.SegmentorTrainer(_plan(heads, JPlan), jv.config, mesh,
                                    output_dir=str(tmp_path / "j"), variant=jv,
                                    label_manager=jlm, augment=JAugment(**NO_DA))
    params = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    tr = ttrainer.SegmentorTrainer(_plan(heads), tv.config, output_dir=str(tmp_path / "t"),
                                   variant=tv, label_manager=tlm, augment=AugmentConfig(**NO_DA),
                                   device="cpu")
    tr.net.load_state_dict(dynunet_from_flax(params, _plan(heads).network_config()))
    rng = np.random.default_rng(1)
    data = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    seg = _labels(rng, 2, 16, tlm.has_ignore_label)
    seg[1, :, :2] = -1  # crop padding
    jseg = jnp.maximum(jnp.asarray(seg), 0)
    n_labels = jtr._mask_lut.shape[0] - 1
    seg_list = [jseg, jtrainer._downsample_seg(jseg, 2, n_labels)]
    jloss, _ = jtr._loss(jtr.state.params, jtr.state.batch_stats, jnp.asarray(data), seg_list)
    x, s = tr._to_device(data, seg)
    assert abs(float(tr.loss_and_grads(x, s)) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    tr.net.eval()
    got = tr.val_step(data, seg)
    want = jtr._val_step(jtr.state.params, jtr.state.batch_stats, jnp.asarray(data),
                         jnp.asarray(seg))
    assert abs(float(got[0]) - float(want[0])) <= LOSS_TOL * abs(float(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy().astype(np.float64), np.asarray(b, np.float64))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_predictor_masks_and_npz_match_jax(regime, tmp_path):
    """Regions paint in regions_class_order where the logit > 0; plain labels
    map the argmax through the label values; the npz holds the regime's
    probabilities."""
    tlm, jlm = _lms(regime)
    heads = tlm.num_segmentation_heads
    jplan, tplan = _plan(heads, JPlan), _plan(heads)
    from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet

    params = jax.tree_util.tree_map(np.asarray, JDynUNet(jplan.network_config()).init(
        jax.random.key(2), jnp.zeros((1, 16, 16, 3)))["params"])
    jpred = JPredictor(jplan, params, dtype=jnp.float32, label_manager=jlm)
    tpred = TPredictor(tplan, dynunet_from_flax(params, tplan.network_config()),
                       dtype=torch.float32, device="cpu", label_manager=tlm)
    rng = np.random.default_rng(3)
    img = rng.random((28, 24, 3)).astype(np.float32)
    a, b = tpred.predict(img), np.asarray(jpred.predict(img))
    assert a.shape == b.shape == (28, 24) and (a == b).mean() >= MASK_AGREEMENT
    logits = tpred.predict_logits(img)
    np.testing.assert_array_equal(a, tlm.convert_logits_to_segmentation(logits))
    np.testing.assert_allclose(logits, jpred.predict_logits(img), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tpred.predict_probabilities(img),
                                  jlm.apply_inference_nonlin(logits))
    for lm_t, lm_j in ((tlm, jlm), (None, None)):
        texport.save_probabilities_npz(logits, str(tmp_path / "t.npz"), label_manager=lm_t)
        jexport.save_probabilities_npz(logits, str(tmp_path / "j.npz"), label_manager=lm_j)
        with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
            assert zt["probabilities"].dtype == np.float16
            assert zt["probabilities"].shape == (28, 24, heads)
            np.testing.assert_array_equal(zt["probabilities"], zj["probabilities"])


@pytest.mark.parametrize("regime", list(REGIMES))
def test_region_and_ignore_summary_and_postprocessing_match_jax(regime, tmp_path):
    tlm, _ = _lms(regime)
    rng = np.random.default_rng(4)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    preds, gts = [], []
    for i in range(3):
        gt = _labels(rng, 1, 24, tlm.has_ignore_label)[0].astype(np.uint8)
        pred = np.where(rng.random(gt.shape) < 0.8, np.minimum(gt, 3),
                        rng.integers(0, 4, gt.shape)).astype(np.uint8)
        Image.fromarray(pred).save(pred_dir / f"c{i}.png")
        Image.fromarray(gt).save(gt_dir / f"c{i}.png")
        preds.append(pred)
        gts.append(gt)
    kw = dict(regions_or_labels=tlm.labels_or_regions_for_eval, ignore_label=tlm.ignore_label)
    got = t_metrics(str(pred_dir), str(gt_dir), 4, output_file=str(tmp_path / "t.json"), **kw)
    want = j_metrics(str(pred_dir), str(gt_dir), 4, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert set(got["mean"]) == {str(r) for r in tlm.labels_or_regions_for_eval}
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(want))
    n = max(list(tlm.all_labels) + [tlm.ignore_label or 0]) + 1
    assert t_pp(preds, gts, n, ignore_label=tlm.ignore_label) == \
        j_pp(preds, gts, n, ignore_label=tlm.ignore_label)
