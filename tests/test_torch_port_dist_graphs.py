"""Both trainers' steps over a mesh as programs (``core/graphs.py``), on
the CPU: two gloo ranks (``tests/torch_port_dist_worker.py``, task
``graphs``) over a (data=1, fsdp=2) mesh, stage 1 under FSDP2 and the
segmentor data-parallel with batch Dice, step through their ``Jit``s (on
the CPU each call runs the step function; the card tests and
``chip_smoke.py`` hold the captured replays to it): one program per batch
signature, its calls counted. One step of each trainer, over the mesh and
on one device, runs under ``HostReadGuard``, which lists every op that
reads a tensor's value to the host (``aten._local_scalar_dense``,
``is_nonzero``, ``nonzero``, ``equal``): a captured step may hold none.
The optimizers are as on a card (``card_optimizer``: AdamW ``capturable``,
its count on the device; the CPU's own AdamW reads a host count by
design). The steps' numbers against the JAX trainers on a mesh are held
by ``test_torch_port_dist.py`` and ``test_torch_port_dist_seg.py``.
"""
import json
import warnings

import numpy as np
import pytest

from torch_port_common import rank_outputs, spawn_ranks, write_inputs
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)
from torch_port_dist_worker import HostReadGuard, card_optimizer

STAGE1 = dict(anchors=8, negatives=16, classes=4, steps=5)
PLAN = dict(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
            strides=(1, 2, 2), n_conv_per_stage=2, num_classes=4, in_channels=3,
            normalization="zscore_image", intensity_properties={}, median_shape=(48, 48),
            batch_dice=True)


def _batches(rng):
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((4, 64, 64), np.int64)
    labels[:, :32] = 1
    labels[:, 32:, :32] = 2
    labels[1::2, :8, :8] = 3
    data = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    seg = rng.integers(-1, 4, (2, 32, 32)).astype(np.int32)
    return images, labels, data, seg


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The two ranks, started first: they run while the one-device test
    computes."""
    root = tmp_path_factory.mktemp("graphs")
    procs = spawn_ranks("graphs", 2, root, 1, 2)
    images, labels, data, seg = _batches(np.random.default_rng(0))
    write_inputs(root, images=images, labels=labels, data=data, seg=seg,
                 config=json.dumps({**STAGE1, "plan": PLAN}))
    try:
        yield root, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(started):
    """The two ranks' outputs."""
    root, procs = started
    return rank_outputs(procs, root)


def test_one_device_steps_read_nothing_to_the_host(started, tmp_path, monkeypatch):
    """The one-device steps under the same guard: stage 1 (its second step,
    as a capture sees it) and the segmentor's train and validation steps
    (while the ranks run)."""
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig, SegmentorTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    images, labels, data, seg = _batches(np.random.default_rng(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        info = InfoNceLoss.create(device="cpu", num_anchors=STAGE1["anchors"],
                                  num_negatives=STAGE1["negatives"],
                                  num_classes=STAGE1["classes"])
    tr = DiffusionWarmupTrainer(
        SDComponents.random(device="cpu"),
        DiffusionTrainConfig(compute_dtype="float32", num_classes=STAGE1["classes"],
                             num_inference_steps=STAGE1["steps"]), info_nce=info)
    card_optimizer(tr.opt, monkeypatch)
    tr.train_step(images[:1], labels[:1])
    with HostReadGuard() as guard:
        tr.train_step(images[1:2], labels[1:2])
    assert guard.reads == []
    st = SegmentorTrainer(SegPlan(**PLAN), SegmentorTrainConfig(compute_dtype="float32"),
                          output_dir=str(tmp_path / "seg"), device="cpu")
    st.train_step(data, seg, lr=0.01)
    with HostReadGuard() as guard:
        st.train_step(data, seg, lr=0.01)
        st.val_step(data, seg)
    assert guard.reads == []
    (train,), (val,) = st.train_program.programs.values(), st.val_program.programs.values()
    assert train.calls == 2 and val.calls == 1


def test_stage1_steps_over_fsdp2_go_through_one_program_per_batch_shape(ranks):
    for r in ranks:
        assert bool(r["stage1_sharded"])
        # two steps of half the batch through one program, one of the whole batch
        assert list(r["stage1_calls"]) == [1, 2]
        assert np.isfinite(r["stage1_losses"]).all()
    # the global batch's losses, the same on each rank
    np.testing.assert_array_equal(ranks[0]["stage1_losses"], ranks[1]["stage1_losses"])


def test_segmentor_steps_over_the_mesh_go_through_one_program_each(ranks):
    for r in ranks:
        assert list(r["seg_train_calls"]) == [2] and list(r["seg_val_calls"]) == [2]
        assert bool(r["seg_val_equal"])
        assert np.isfinite([float(r["seg_loss"]), float(r["seg_val_loss"])]).all()
    for key in ("seg_loss", "seg_val_loss"):
        assert float(ranks[0][key]) == float(ranks[1][key])


@pytest.mark.parametrize("trainer", ["stage1", "seg"])
def test_a_mesh_step_reads_nothing_to_the_host(ranks, trainer):
    for r in ranks:
        assert list(r[f"{trainer}_reads"]) == []


def test_the_guard_sees_each_kind_of_host_read():
    import torch

    x = torch.arange(4.0)
    reads = []
    for read in (lambda: float(x.sum()), lambda: bool(x.sum()), lambda: x.nonzero(),
                 lambda: torch.equal(x, x)):
        with HostReadGuard() as guard:
            read()
        reads.append(len(guard.reads))
    assert all(reads), reads
