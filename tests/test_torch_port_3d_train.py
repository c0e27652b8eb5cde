"""3D training in the port against the JAX package's, on the CPU at a tiny
3D plan in float32: the mode pool over per-axis strides, one SGD step with a
batch-Dice and a sample-Dice plan (the JAX trainer's ``_train_step``, DA
off), the trainer's 3D set-up (host 3D spatial DA, dummy-2D for an
anisotropic patch, the variants' 3D mirror axes), and the final validation
writing ``.npy`` cases scored as the JAX package scores them.

Tolerances (float32 on both sides; only the order of sums differs):
- the mode pool: equal;
- one SGD step: the loss 1e-6 relative; parameters and the momentum within
  5e-5 of each tensor's largest value; a conv bias that feeds an
  InstanceNorm has a gradient of 0 in exact arithmetic, so its gradient and
  momentum are rounding noise (≈ 1e-8): it is held to 5e-5 absolutely;
- ``summary.json`` of the port's validation folder against the JAX
  package's scoring of the same folder: equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data.augment import AugmentConfig as JAugment
from ldiffusion_tpu.evaluate import compute_metrics_on_folder as j_metrics
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor.planner3d import SegPlan3D as JPlan
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.augment import AugmentConfig, HostSpatialAugmenter3D
from ldiffusion_tpu_torch.models.convert import dynunet3d_from_flax
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3D
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
from ldiffusion_tpu_torch.segmentor.variants import get_variant

NO_DA = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
             p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)
PLAN = dict(patch_size=(8, 16, 16), batch_size=2, spacing=(1.0, 1.0, 1.0),
            features_per_stage=(8, 16, 32), strides=((1, 1, 1), (2, 2, 2), (1, 2, 2)),
            kernel_sizes=((3, 3, 3),) * 3, n_conv_per_stage=2, num_classes=3, in_channels=1,
            normalization="zscore", median_shape=(10, 20, 20), batch_dice=True)
STEP_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels(rng, n, shape, classes):
    return np.stack([np.kron(rng.integers(0, classes, (shape[0] // 4, shape[1] // 4,
                                                       shape[2] // 4)),
                             np.ones((4, 4, 4), np.int64)) for _ in range(n)]).astype(np.int32)


def test_mode_pool_over_per_axis_strides_matches_jax():
    rng = np.random.default_rng(0)
    seg = rng.integers(-1, 4, (2, 8, 12, 16)).astype(np.int32)
    seg[0, :2, :4, :4] = -1
    for s in ((1, 2, 2), (2, 2, 2), (2, 1, 1), 2):
        want = np.asarray(jtrainer._downsample_seg(jnp.asarray(seg), s, 4))
        got = ttrainer.downsample_seg(torch.from_numpy(seg), s, 4).numpy()
        np.testing.assert_array_equal(got, want)


def _step_err(got: dict, want: dict) -> float:
    worst = 0.0
    for k, ref in want.items():
        scale = max(float(ref.abs().max()), 1.0 if k.endswith(".conv.bias") else 1e-30)
        worst = max(worst, float((got[k] - ref).abs().max()) / scale)
    return worst


def _find_trace(state):
    if hasattr(state, "trace") and isinstance(state.trace, dict):
        return state.trace
    children = state if isinstance(state, (tuple, list)) else \
        [getattr(state, f) for f in getattr(state, "_fields", ())]
    for child in children:
        found = _find_trace(child)
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("batch_dice", [True, False])
def test_one_sgd_step_matches_jax(tmp_path, batch_dice):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(2, 8, 16, 16, 1)).astype(np.float32)
    seg = _labels(rng, 2, (8, 16, 16), 3)
    seg[0, :2] = -1  # crop padding: trains as background
    plan = dict(PLAN, batch_dice=batch_dice)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.SegmentorTrainer(JPlan(**plan), JConfig(compute_dtype="float32"), mesh,
                                    output_dir=str(tmp_path / "j"), augment=JAugment(**NO_DA))
    params0 = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    state, jloss = jtr._train_step(jtr.state, jnp.asarray(data), jnp.asarray(seg),
                                   jax.random.key(0), jnp.float32(0.01))
    cfg = SegPlan3D(**plan).network_config()
    tr = ttrainer.SegmentorTrainer(SegPlan3D(**plan), SegmentorTrainConfig(compute_dtype="float32"),
                                   output_dir=str(tmp_path / "t"), augment=AugmentConfig(**NO_DA),
                                   device="cpu")
    assert isinstance(tr.net, DynUNet3D) and tr.host_spatial is None
    tr.net.load_state_dict(dynunet3d_from_flax(params0, cfg))
    loss = tr.train_step(data, seg, lr=0.01)
    assert abs(float(loss) - float(jloss)) / abs(float(jloss)) <= 1e-6
    want_params = dynunet3d_from_flax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
    want_mom = dynunet3d_from_flax(
        jax.tree_util.tree_map(np.asarray, _find_trace(state.opt_state)), cfg)
    got_params = {k: v.detach() for k, v in tr.net.named_parameters()}
    assert _step_err(got_params, want_params) <= STEP_TOL
    assert _step_err(tr._momentum_state(), want_mom) <= STEP_TOL


def test_3d_trainer_setup(tmp_path):
    cfg = SegmentorTrainConfig(compute_dtype="float32")
    tr = ttrainer.SegmentorTrainer(SegPlan3D(**PLAN), cfg, output_dir=str(tmp_path / "a"),
                                   device="cpu")
    assert isinstance(tr.host_spatial, HostSpatialAugmenter3D) and not tr.host_spatial.dummy_2d
    assert tr.host_spatial.cfg.rotation_max_3d == pytest.approx(np.pi / 6)
    assert len(tr.train_patch_size) == 3 and tr.augment_cfg.p_rotation == 0.0
    aniso = dict(PLAN, patch_size=(4, 16, 16), strides=((1, 1, 1), (1, 2, 2), (1, 2, 2)))
    tr = ttrainer.SegmentorTrainer(SegPlan3D(**aniso), cfg, output_dir=str(tmp_path / "b"),
                                   device="cpu")
    assert tr.host_spatial.dummy_2d and tr.train_patch_size[0] == 4
    # onlyMirror01 keeps (0, 1) in 3D, (0,) is its 2D restriction
    tr = ttrainer.SegmentorTrainer(SegPlan3D(**PLAN), cfg, output_dir=str(tmp_path / "c"),
                                   device="cpu", variant=get_variant("nnUNetTrainer_onlyMirror01"))
    assert tr.augment_cfg.mirror_axes == (0, 1)
    with pytest.raises(ValueError, match="2D"):
        ttrainer.SegmentorTrainer(SegPlan3D(**PLAN), cfg, output_dir=str(tmp_path / "d"),
                                  device="cpu", variant=get_variant("nnUNetTrainerBN"))
    # a cascade plan widens the input by the foreground labels
    casc = ttrainer.SegmentorTrainer(SegPlan3D(**dict(PLAN, previous_stage="3d_lowres")), cfg,
                                     output_dir=str(tmp_path / "e"), device="cpu")
    assert casc.net.enc_0_0.conv.in_channels == 1 + 2


def test_validation_writes_npy_cases_scored_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    cfg = SegmentorTrainConfig(compute_dtype="float32")
    tr = ttrainer.SegmentorTrainer(SegPlan3D(**PLAN), cfg, output_dir=str(tmp_path),
                                   augment=AugmentConfig(**NO_DA), device="cpu")
    images = [rng.normal(size=(10, 20, 18, 1)).astype(np.float32) for _ in range(2)]
    labels = [_labels(rng, 1, (12, 20, 20), 3)[0][:10, :, :18] for _ in range(2)]
    summary = tr.perform_actual_validation(images, labels, save_npz=True)
    out = os.path.join(tmp_path, "validation")
    assert sorted(f for f in os.listdir(out) if f.endswith(".npy")) == \
        ["case_000.npy", "case_001.npy"]
    mask = np.load(os.path.join(out, "case_000.npy"))
    assert mask.shape == (10, 20, 18) and mask.dtype == np.uint8 and mask.max() <= 2
    with np.load(os.path.join(out, "case_000.npz")) as z:
        assert z["probabilities"].shape == (10, 20, 18, 3)
    want = j_metrics(out, os.path.join(tmp_path, "validation_gt"), 3)
    assert json.loads(json.dumps(summary)) == json.loads(json.dumps(want))
    assert os.path.exists(os.path.join(tmp_path, "postprocessing.json"))
    tr.save_checkpoint(str(tmp_path / "ck.pkl"))
    tr2 = ttrainer.SegmentorTrainer(SegPlan3D(**PLAN), cfg, output_dir=str(tmp_path / "r"),
                                    device="cpu")
    tr2.load_checkpoint(str(tmp_path / "ck.pkl"))
    for (k, a), b in zip(tr.net.state_dict().items(), tr2.net.state_dict().values()):
        assert torch.equal(a, b), k
