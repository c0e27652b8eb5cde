"""Stage 2 of the port over two gloo ranks (DDP over a (data=2) mesh,
``tests/torch_port_dist_worker.py``) on the CPU: one segmentor step with
batch Dice, plain and ``nnUNetTrainerBN``, against the JAX
``SegmentorTrainer`` on ``make_mesh(MeshConfig(data=2))`` over two of the
eight virtual CPU devices and against the port in one process; the
batch-Dice gradient alone against the one-process gradient; the final
validation split over the ranks.

Tolerances, f32 on every side (only the order of sums differs):
- against JAX, those of ``test_torch_port_seg_train.py``: the loss 1e-6
  relative; parameters and the momentum within 5e-5 of each tensor's largest
  value (a conv bias in front of an InstanceNorm: 5e-5 absolutely, its
  gradient is rounding noise); a BN net's running statistics likewise;
- against the port in one process: the same, the loss 1e-6 relative;
- the batch-Dice gradient: 1e-5 of its largest value (measured below 1e-6);
  a factor of W = 2, or of 1/W, is off by 50% or 100%;
- the validation summary: its Dice values equal (the same predictions).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data.augment import AugmentConfig as JAugment
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu.segmentor.variants import get_variant as j_variant
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.augment import AugmentConfig
from ldiffusion_tpu_torch.losses.dice import soft_dice_loss
from ldiffusion_tpu_torch.models.convert import (
    dynunet_batch_stats_to_flax,
    dynunet_from_flax,
    dynunet_to_flax,
    flatten_tree,
)
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.variants import get_variant
from test_torch_port_seg_train import _find_trace
from torch_port_common import flat, rank_outputs, spawn_ranks, write_inputs
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

NO_DA = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
             p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)
PLAN = dict(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
            strides=(1, 2, 2), n_conv_per_stage=2, num_classes=4, in_channels=3,
            normalization="zscore_image", intensity_properties={}, median_shape=(48, 48),
            batch_dice=True)
LOSS_TOL, STEP_TOL, DICE_GRAD_TOL = 1e-6, 5e-5, 1e-5


def _labels(rng, n, size, classes):
    return np.stack([np.kron(rng.integers(0, classes, (size // 8, size // 8)),
                             np.ones((8, 8), np.int64)) for _ in range(n)]).astype(np.int32)


def _step_err(got: dict, want: dict) -> float:
    """The largest error of any tensor over its largest value (1 for a conv
    bias: absolute)."""
    worst = 0.0
    for k, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1.0 if k.endswith("conv/bias") else 1e-30)
        worst = max(worst, float(np.abs(got[k] - ref).max()) / scale)
    return worst


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    """The JAX trainer's ``net.init`` in one compile: op by op it compiles
    about 90 small programs (~20 s on the CPU). The values are the same; both
    packages start from them."""
    real = JDynUNet.init
    monkeypatch.setattr(JDynUNet, "init",
                        lambda self, key, x: jax.jit(lambda k, v: real(self, k, v))(key, x))


@pytest.fixture
def rank_dirs(request, tmp_path):
    """The test's ranks, started before it computes their inputs (a rank
    spends seconds importing torch before it needs them); killed if the
    test fails first."""
    task, *args = request.param
    procs = spawn_ranks(task, 2, tmp_path / "ranks", *args)
    yield tmp_path / "ranks", procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_step(tmp, variant, data, seg):
    mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    config = JConfig(compute_dtype="float32")
    v = j_variant(variant, base=config) if variant else None
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), config, mesh, output_dir=str(tmp),
                                    augment=JAugment(**NO_DA), variant=v)
    init = (jax.tree_util.tree_map(np.asarray, jtr.state.params),
            jax.tree_util.tree_map(np.asarray, jtr.state.batch_stats))
    state, loss = jtr._train_step(jtr.state, mesh.shard_batch(jnp.asarray(data)),
                                  mesh.shard_batch(jnp.asarray(seg)), jax.random.key(0),
                                  jnp.float32(0.01))
    trace = _find_trace(state.opt_state)
    out = {"loss": float(loss), **{f"params/{k}": v for k, v in flat(state.params).items()},
           **{f"momentum/{k}": v for k, v in flat(trace).items()},
           **{f"stats/{k}": v for k, v in flat(state.batch_stats).items()}}
    return init, out


def _port_step(tmp, variant, init, data, seg):
    config = SegmentorTrainConfig(compute_dtype="float32")
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), config, output_dir=str(tmp),
                                   augment=AugmentConfig(**NO_DA), device="cpu",
                                   variant=get_variant(variant, base=config) if variant else None)
    tr.net.load_state_dict(dynunet_from_flax(init[0], tr.net_config, init[1] or None))
    loss = tr.train_step(data, seg, lr=0.01)
    sd = tr.net.state_dict()
    return tr, {"loss": float(loss),
                **{f"params/{k}": v for k, v in flatten_tree(
                    dynunet_to_flax(sd, tr.net_config)).items()},
                **{f"momentum/{k}": v for k, v in flatten_tree(
                    dynunet_to_flax(tr._momentum_state(), tr.net_config)).items()},
                **{f"stats/{k}": v for k, v in flatten_tree(
                    dynunet_batch_stats_to_flax(sd, tr.net_config)).items()}}


def _check(got: dict, want: dict):
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=LOSS_TOL)
    for kind in ("params", "momentum", "stats"):
        names = {k for k in want if k.startswith(kind + "/")}
        assert names == {k for k in got if k.startswith(kind + "/")}, kind
        assert _step_err({k: got[k] for k in names}, {k: want[k] for k in names}) <= STEP_TOL


@pytest.mark.parametrize("variant,rank_dirs", [(None, ("seg", 2, 0)),
                                               ("nnUNetTrainerBN", ("seg", 2, 1))],
                         indirect=["rank_dirs"], ids=["plain", "bn"])
def test_ddp_segmentor_step_matches_jax_and_one_process(variant, tmp_path, rank_dirs):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    seg = _labels(rng, 2, 32, 4)
    seg[0, :4] = -1  # crop padding: trains as background
    root, procs = rank_dirs
    init, want = _jax_step(tmp_path / "j", variant, data, seg)
    write_inputs(root, data=data, seg=seg, config=json.dumps(
        {"plan": PLAN, "augment": NO_DA}),
        **{f"params/{k}": v for k, v in flat(init[0]).items()},
        **{f"stats/{k}": v for k, v in flat(init[1]).items()})
    _, one = _port_step(tmp_path / "t", variant, init, data, seg)
    ranks = rank_outputs(procs, root)
    assert (variant is not None) == any(k.startswith("stats/") for k in want)
    for r in ranks:
        _check(r, want)
        _check(r, one)
    for k, v in ranks[0].items():  # replicated: the ranks hold the same state
        np.testing.assert_array_equal(ranks[1][k], v)


@pytest.mark.parametrize("rank_dirs", [("dice", 2)], indirect=True, ids=["two_ranks"])
def test_batch_dice_gradient_is_the_global_batchs(rank_dirs):
    """The Dice of the global batch through ``all_reduce_sum``, each rank its
    rows, then DDP's mean: the one-process gradient, not W times or 1/W of
    it."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    seg = _labels(rng, 4, 8, 3)
    weight = rng.normal(size=(3, 3, 1, 1)).astype(np.float32)
    root, procs = rank_dirs
    write_inputs(root, data=data, seg=seg, weight=weight, classes=3)
    conv = torch.nn.Conv2d(3, 3, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight))
        conv.bias.zero_()
    loss = soft_dice_loss(conv(torch.from_numpy(data).permute(0, 3, 1, 2)),
                          torch.from_numpy(seg))
    loss.backward()
    want = conv.weight.grad.numpy()
    for r in rank_outputs(procs, root):
        assert float(r["loss"]) == pytest.approx(loss.item(), rel=1e-6)
        err = float(np.abs(r["grad"] - want).max()) / float(np.abs(want).max())
        assert err <= DICE_GRAD_TOL, err


@pytest.mark.parametrize("rank_dirs", [("val", 2)], indirect=True, ids=["two_ranks"])
def test_final_validation_splits_the_cases_over_the_ranks(tmp_path, rank_dirs):
    rng = np.random.default_rng(4)
    images = [np.kron(rng.random((6, 6, 3)), np.ones((8, 8, 1))).astype(np.float32)
              + 0.05 * rng.normal(size=(48, 48, 3)).astype(np.float32) for _ in range(4)]
    labels = list(_labels(rng, 4, 48, 4))
    config = SegmentorTrainConfig(compute_dtype="float32")
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), config, output_dir=str(tmp_path / "one"),
                                   device="cpu")
    params = dynunet_to_flax(tr.net.state_dict(), tr.net_config)
    root, procs = rank_dirs
    write_inputs(root, cases=4, config=json.dumps({"plan": PLAN, "augment": NO_DA}),
                 **{f"params/{k}": v for k, v in flatten_tree(params).items()},
                 **{f"image_{i}": a for i, a in enumerate(images)},
                 **{f"label_{i}": a for i, a in enumerate(labels)})
    want = tr.perform_actual_validation(images, labels)
    ranks = rank_outputs(procs, root)
    assert [int(r["cases"]) for r in ranks] == [2, 2]  # cases 0, 2 and 1, 3
    assert [int(r["scored"]) for r in ranks] == [1, 0]  # rank 0 alone scores
    out = root / "seg" / "validation"
    assert sorted(p.name for p in out.glob("case_*.png")) == \
        [f"case_{i:03d}.png" for i in range(4)]
    assert (root / "seg" / "postprocessing.json").exists()
    for r in ranks:  # rank 1 reads rank 0's summary
        got = json.loads(str(r["summary"]))
        assert got["foreground_mean"] == want["foreground_mean"]
        assert got["mean"] == want["mean"]
        assert [c["metrics"] for c in got["metric_per_case"]] == \
            [c["metrics"] for c in want["metric_per_case"]]
    assert json.loads((out / "summary.json").read_text())["foreground_mean"] == \
        want["foreground_mean"]
