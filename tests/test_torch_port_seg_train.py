"""Stage-2 training of the port against the JAX package's, on the CPU at tiny
plans in float32: the losses, the DynUNet's training forward, one SGD step,
``run_training`` and the final validation (the whole slice through the API:
``test_torch_port_seg_api``).

Tolerances (float32 on both sides; only the order of sums differs):
- losses: 1e-6 relative; the mode pool exactly;
- every deep-supervision head of the training forward: 1e-4 absolute;
- one SGD step: the loss 1e-6 relative; parameters and the momentum within
  5e-5 of each tensor's largest value (the stage-1 step reaches 1.6e-5,
  ``test_torch_port_train``).
  A conv bias that feeds an InstanceNorm has a gradient of 0 in exact
  arithmetic, so its gradient and momentum are rounding noise (≈ 1e-8): it
  is held to 5e-5 absolutely;
- masks of the JAX predictor reading the port's checkpoint (both f32): equal
  on ≥ 99.5% of pixels, the slice tolerance of ``test_torch_port_api``;
- ``summary.json`` from the same predictions: 1e-12.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ldiffusion_tpu.core.checkpoint import load_pytree as j_load_pytree
from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data.augment import AugmentConfig as JAugment
from ldiffusion_tpu.evaluate import compute_metrics_on_folder as j_metrics
from ldiffusion_tpu.losses import dice as jdice
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu.segmentor.postprocess import determine_postprocessing as j_pp
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.augment import AugmentConfig
from ldiffusion_tpu_torch.losses import dice as tdice
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor
from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

NO_DA = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
             p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)
PLAN = dict(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
            strides=(1, 2, 2), n_conv_per_stage=2, num_classes=4, in_channels=3,
            normalization="zscore_image", intensity_properties={}, median_shape=(48, 48),
            batch_dice=True)
MASK_AGREEMENT = 0.995
STEP_TOL = 5e-5


def _mesh():
    return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


def _labels(rng, n, size, classes):
    return np.stack([np.kron(rng.integers(0, classes, (size // 8, size // 8)),
                             np.ones((8, 8), np.int64)) for _ in range(n)]).astype(np.int32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------------------------------
# losses, the mode pool, the training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_dice", [True, False])
def test_losses_match_jax(batch_dice):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 16, 16, 4)) * 2).astype(np.float32)
    tgt = _labels(rng, 2, 16, 4)
    t_logits, t_tgt = _nchw(logits), torch.from_numpy(tgt)
    j_logits, j_tgt = jnp.asarray(logits), jnp.asarray(tgt)
    assert _rel(tdice.soft_dice_loss(t_logits, t_tgt, batch_dice=batch_dice),
                jdice.soft_dice_loss(j_logits, j_tgt, batch_dice=batch_dice)) <= 1e-6
    assert _rel(tdice.robust_cross_entropy(t_logits, t_tgt),
                jdice.robust_cross_entropy(j_logits, j_tgt)) <= 1e-6
    assert _rel(tdice.dc_and_ce_loss(t_logits, t_tgt, batch_dice=batch_dice),
                jdice.dc_and_ce_loss(j_logits, j_tgt, batch_dice=batch_dice)) <= 1e-6
    heads = [logits, logits[:, ::2, ::2], logits[:, ::4, ::4]]
    tgts = [tgt, tgt[:, ::2, ::2], tgt[:, ::4, ::4]]
    want = jdice.deep_supervision_loss(
        [jnp.asarray(h) for h in heads], [jnp.asarray(t) for t in tgts],
        lambda lg, tg: jdice.dc_and_ce_loss(lg, tg, batch_dice=batch_dice))
    got = tdice.deep_supervision_loss(
        [_nchw(h) for h in heads], [torch.from_numpy(np.ascontiguousarray(t)) for t in tgts],
        lambda lg, tg: tdice.dc_and_ce_loss(lg, tg, batch_dice=batch_dice))
    assert _rel(got, want) <= 1e-6


def test_mode_pool_matches_jax_exactly():
    rng = np.random.default_rng(1)
    seg = rng.integers(-1, 5, (3, 32, 24)).astype(np.int32)
    seg[0, :8, :8] = -1  # padding that dominates its windows
    for s in (2, 4):
        want = np.asarray(jtrainer._downsample_seg(jnp.asarray(seg), s, 5))
        got = ttrainer.downsample_seg(torch.from_numpy(seg), s, 5).numpy()
        np.testing.assert_array_equal(got, want)


def test_poly_lr_and_the_clip_order():
    for e in (0, 1, 37, 89):
        assert ttrainer.poly_lr(0.01, e, 90) == jtrainer.poly_lr(0.01, e, 90)
    # clip the raw gradient first, then the optimizer adds wd·θ (trainer.py:204-212)
    p = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    p.grad = torch.tensor([30.0, 40.0])  # norm 50 → clipped to 12
    opt = torch.optim.SGD([p], lr=0.1, momentum=0.99, nesterov=True, weight_decay=0.5)
    torch.nn.utils.clip_grad_norm_([p], 12.0)
    opt.step()
    g = np.array([30.0, 40.0]) * 12.0 / 50.0 + 0.5 * np.array([3.0, 4.0])
    np.testing.assert_allclose(p.detach().numpy(), np.array([3.0, 4.0]) - 0.1 * 1.99 * g,
                               rtol=1e-6)


def test_training_forward_returns_every_head_like_flax():
    plan = JPlan(**PLAN)
    jnet = JDynUNet(plan.network_config())
    params = jax.jit(jnet.init)(jax.random.key(2), jnp.zeros((1, 32, 32, 3)))["params"]
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda p, v: jnet.apply({"params": p}, v, train=True))(params,
                                                                          jnp.asarray(x))
    cfg = SegPlan(**PLAN).network_config()
    net = DynUNet(cfg)
    net.load_state_dict(dynunet_from_flax(params, cfg))
    got = net(_nchw(x), train=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(net(_nchw(x)).detach().numpy(), got[0].detach().numpy(),
                               atol=1e-6)
    # bf16 compute over f32 parameters: the parameters stay f32, the heads are f32
    net.compute_dtype = torch.bfloat16
    out = net(_nchw(x), train=True)
    assert net.seg_0.weight.dtype == torch.float32 and out[0].dtype == torch.float32
    assert float((out[0] - got[0]).detach().abs().max()) < 0.1


# ---------------------------------------------------------------------------
# one SGD step against the JAX trainer's
# ---------------------------------------------------------------------------

def _find_trace(state):
    """The SGD momentum (optax TraceState.trace) inside the JAX optimizer state."""
    if hasattr(state, "trace") and isinstance(state.trace, dict):
        return state.trace
    children = state if isinstance(state, (tuple, list)) else \
        [getattr(state, f) for f in getattr(state, "_fields", ())]
    for child in children:
        found = _find_trace(child)
        if found is not None:
            return found
    return None


def _step_err(got: dict, want: dict) -> float:
    worst = 0.0
    for k, ref in want.items():
        scale = max(float(ref.abs().max()), 1.0 if k.endswith(".conv.bias") else 1e-30)
        worst = max(worst, float((got[k] - ref).abs().max()) / scale)
    return worst


def test_one_sgd_step_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    seg = _labels(rng, 2, 32, 4)
    seg[0, :4] = -1  # crop padding: trains as background
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), JConfig(compute_dtype="float32"), _mesh(),
                                    output_dir=str(tmp_path / "j"), augment=JAugment(**NO_DA))
    params0 = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    state, jloss = jtr._train_step(jtr.state, jnp.asarray(data), jnp.asarray(seg),
                                   jax.random.key(0), jnp.float32(0.01))
    cfg = SegPlan(**PLAN).network_config()
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), SegmentorTrainConfig(compute_dtype="float32"),
                                   output_dir=str(tmp_path / "t"), augment=AugmentConfig(**NO_DA),
                                   device="cpu")
    tr.net.load_state_dict(dynunet_from_flax(params0, cfg))
    loss = tr.train_step(data, seg, lr=0.01)
    assert _rel(loss, jloss) <= 1e-6
    want_params = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
    want_mom = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, _find_trace(state.opt_state)),
                                 cfg)
    got_params = {k: v.detach() for k, v in tr.net.named_parameters()}
    assert _step_err(got_params, want_params) <= STEP_TOL
    assert _step_err(tr._momentum_state(), want_mom) <= STEP_TOL
    assert tr.step == int(state.step) == 1


def test_unported_options_raise_naming_the_roadmap(tmp_path):
    """Variants, label managers, DA5, the residual encoder and 3D plans,
    which raised before they were ported, now build a trainer (their parity
    is in ``test_torch_port_seg_variants``/``_label_regimes``/``_da5``/
    ``_nets``/``_3d_train``)."""
    from ldiffusion_tpu_torch.segmentor.label_manager import LabelManager
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    plan = SegPlan(**PLAN)
    cfg = SegmentorTrainConfig(compute_dtype="float32")
    regions = LabelManager({"background": 0, "a": (1, 2, 3), "b": (2,)}, [1, 2])
    for kw in (dict(variant=get_variant("nnUNetTrainerBN")),
               dict(label_manager=LabelManager({f"c{i}": i for i in range(4)})),
               dict(augment=AugmentConfig(p_rot90=0.5))):
        ttrainer.SegmentorTrainer(plan, cfg, output_dir=str(tmp_path), device="cpu", **kw)
    ttrainer.SegmentorTrainer(dataclasses.replace(plan, block_type="residual"), cfg,
                              output_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="heads"):  # 4 heads, 2 regions
        ttrainer.SegmentorTrainer(plan, cfg, output_dir=str(tmp_path), device="cpu",
                                  label_manager=regions)
    # a 3D plan builds the 3D trainer (its parity: ``test_torch_port_3d_train``)
    from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3D
    from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D

    plan3d = SegPlan3D(patch_size=(8, 8, 8), batch_size=2, spacing=(1.0, 1.0, 1.0),
                       features_per_stage=(8, 16), strides=((1, 1, 1), (2, 2, 2)),
                       kernel_sizes=((3, 3, 3),) * 2, n_conv_per_stage=2, num_classes=4,
                       in_channels=3, normalization="zscore", median_shape=(8, 8, 8),
                       batch_dice=False)
    tr3d = ttrainer.SegmentorTrainer(plan3d, cfg, output_dir=str(tmp_path), device="cpu")
    assert isinstance(tr3d.net, DynUNet3D) and tr3d.is_3d


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 tiny epochs of the port's trainer (default DA) on synthetic cases."""
    root = tmp_path_factory.mktemp("seg_train")
    rng = np.random.default_rng(4)
    images = [np.kron(rng.random((6, 6, 3)), np.ones((8, 8, 1))).astype(np.float32)
              + 0.05 * rng.normal(size=(48, 48, 3)).astype(np.float32) for _ in range(4)]
    labels = list(_labels(rng, 4, 48, 4))
    ds = PreprocessedDataset.build(images, labels, 4)
    plan = SegPlan(**PLAN)
    cfg = SegmentorTrainConfig(num_epochs=2, iters_per_epoch=2, val_iters_per_epoch=1,
                               compute_dtype="float32", save_every=1)
    tr = ttrainer.SegmentorTrainer(plan, cfg, output_dir=str(root / "fold_0"), device="cpu")
    tr.run_training(ds.subset(ds.keys()[:3]), ds.subset(ds.keys()[3:]))
    plan.save(str(root / "plans.json"))
    return {"root": root, "trainer": tr, "images": images, "labels": labels, "cfg": cfg,
            "plan": plan}


def test_run_training_writes_checkpoints_and_resumes(trained, tmp_path):
    tr, fold = trained["trainer"], trained["root"] / "fold_0"
    for name in ("checkpoint_best.pkl", "checkpoint_latest.pkl", "checkpoint_final.pkl",
                 "benchmark_result.json", "debug.json", "training_log.txt"):
        assert (fold / name).exists(), name
    assert tr.current_epoch == 2 and tr.step == 4 and len(tr.iter_seconds) == 4
    assert len(tr.epoch_log.data["ema_fg_dice"]) == 2
    # every write is timed: latest ×2, final, best after epoch 0 and maybe 1
    assert 4 <= len(tr.checkpoint_seconds) <= 5
    ck = j_load_pytree(str(fold / "checkpoint_final.pkl"))  # a plain pickle.load
    assert set(ck) == {"params", "opt_state", "step", "batch_stats", "epoch", "best_ema",
                       "logger", "plan"}
    assert ck["epoch"] == 2 and int(ck["step"]) == 4 and ck["batch_stats"] == {}
    assert json.loads(ck["plan"]) == json.loads(trained["plan"].to_json())
    jparams = jax.jit(JDynUNet(JPlan(**PLAN).network_config()).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    assert jax.tree_util.tree_structure(ck["params"]) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams))
    # resume: epoch, best EMA, logger, parameters and momentum come back
    again = ttrainer.SegmentorTrainer(trained["plan"], trained["cfg"],
                                      output_dir=str(tmp_path), device="cpu")
    again.load_checkpoint(str(fold / "checkpoint_final.pkl"))
    assert (again.current_epoch, again.best_ema, again.step) == (2, tr.best_ema, 4)
    assert again.epoch_log.data == tr.epoch_log.data
    for (k, a), b in zip(again.net.named_parameters(), tr.net.parameters()):
        assert torch.equal(a, b), k
    for k, v in tr._momentum_state().items():
        assert torch.equal(again._momentum_state()[k], v), k
    # continue_training from a finished run trains no further epoch
    cont = ttrainer.SegmentorTrainer(trained["plan"], trained["cfg"],
                                     output_dir=str(fold), device="cpu")
    ds = PreprocessedDataset.build(trained["images"][:2], trained["labels"][:2], 4)
    cont.run_training(ds, ds, continue_training=True)
    assert cont.current_epoch == 2 and cont.step == 4


def test_jax_predictor_reads_the_port_checkpoint(trained):
    root = str(trained["root"])
    plan = trained["plan"]
    ck = str(trained["root"] / "fold_0" / "checkpoint_final.pkl")
    jpred = JPredictor.from_checkpoints(JPlan.load(os.path.join(root, "plans.json")), [ck],
                                        dtype=jnp.float32)
    tpred = TPredictor.from_checkpoints(plan, [ck], dtype=torch.float32, device="cpu")
    for img in trained["images"][:2]:
        a, b = tpred.predict(img), np.asarray(jpred.predict(img))
        assert a.shape == b.shape == (48, 48)
        assert float(np.mean(a == b)) >= MASK_AGREEMENT


def test_final_validation_matches_jax_metrics_and_postprocessing(trained):
    tr = trained["trainer"]
    summary = tr.perform_actual_validation(trained["images"], trained["labels"])
    fold = trained["root"] / "fold_0"
    want = j_metrics(str(fold / "validation"), str(fold / "validation_gt"), 4)
    with open(fold / "validation" / "summary.json") as f:
        written = json.load(f)

    def close(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                close(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                close(x, y)
        elif isinstance(a, float):
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12
        else:
            assert a == b

    close(written, json.loads(json.dumps(want)))
    close(summary, want)
    preds = [np.asarray(Image.open(fold / "validation" / f"case_{i:03d}.png")) for i in range(4)]
    gts = [np.asarray(Image.open(fold / "validation_gt" / f"case_{i:03d}.png"))
           for i in range(4)]
    with open(fold / "postprocessing.json") as f:
        assert json.load(f) == j_pp(preds, gts, 4)
    assert len(tr.val_case_seconds) == 4
    # --npz, which raised before it was ported: the probabilities beside the mask
    tr.perform_actual_validation(trained["images"][:1], trained["labels"][:1], save_npz=True)
    with np.load(fold / "validation" / "case_000.npz") as z:
        probs = z["probabilities"]
    assert probs.shape == (48, 48, 4) and probs.dtype == np.float16
    np.testing.assert_allclose(probs.astype(np.float32).sum(-1), 1.0, atol=4e-3)
    # the mask's class holds the largest float16 probability (ties allowed)
    mask = np.asarray(Image.open(fold / "validation" / "case_000.png")).astype(np.int64)
    assert (np.take_along_axis(probs, mask[..., None], -1)[..., 0] == probs.max(-1)).all()
