"""The port's distribution (``ldiffusion_tpu_torch/core/dist.py``) on the CPU:
the mesh arithmetic against the JAX package's, the launcher hooks, and one
stage-1 step on two gloo ranks under FSDP2, replicated over ``data`` (a
(data=2, fsdp=1) mesh) and sharded over ``fsdp`` (data=1, fsdp=2), each
against the JAX trainer on ``make_mesh`` of the same shape over two of the
eight virtual CPU devices (``tests/conftest.py``) and against the port's
one-process step; and the sharded checkpoint's round trip (the counterpart
of ``__graft_entry__.py:101-127``): gathered on both ranks, written by rank
0 in a layout the JAX package's ``load_pytree`` reads, read back and
re-sharded bit-equal. The ranks are processes of
``tests/torch_port_dist_worker.py`` (torch and the port only), joined
through a ``file://`` rendezvous in ``tmp_path``.

Tolerances, f32 on every side:
- against JAX: those of ``test_torch_port_train.py`` (the loss 1e-5
  relative; gradients and the AdamW first moment 1e-4 of each tensor's
  largest value, the second moment 2e-4; parameters 2e-7 where the
  gradient exceeds 1e-3 of its tensor's largest value, else 2·lr);
- against the port in one process, tighter: the loss and the gradient norm
  1e-6 relative (measured 0 and 3.1e-7); gradients and the first moment
  5e-5 of each tensor's largest value, the second moment 1e-4 (measured
  1.6e-5 and 2.5e-5: each rank convolves one image where one process
  convolves two, and the ranks' mean adds in another order); parameters
  5e-8 where the gradient exceeds 1e-3 of its tensor's largest value
  (measured 7.5e-9), else 2·lr.
"""
import os

import numpy as np
import pytest

from ldiffusion_tpu.core import dist as jdist
from ldiffusion_tpu.core.checkpoint import load_pytree as j_load_pytree
from ldiffusion_tpu.core.config import MeshConfig as JMeshConfig
from ldiffusion_tpu_torch.core import dist as tdist
from ldiffusion_tpu_torch.core.config import MeshConfig
from torch_port_common import (
    assert_step_close,
    flat,
    rank_outputs,
    spawn_ranks,
    stage1_world,
)
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

LOSS_TOL, GRAD_TOL, NU_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-4, 2e-7
PORT_LOSS_TOL, PORT_GRAD_TOL, PORT_NU_TOL, PORT_PARAM_TOL = 1e-6, 5e-5, 1e-4, 5e-8


MESHES = {"replicated": (2, 1), "sharded": (1, 2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return stage1_world(tmp_path_factory.mktemp("stage1"), tuple(MESHES.values()))


def test_local_batch_slice_and_mesh_config_match_jax():
    for batch in (2, 4, 6, 8, 12):
        for n in (1, 2, 3, 4):
            for i in range(n):
                if batch % n:
                    with pytest.raises(AssertionError):
                        tdist.local_batch_slice(batch, n, i)
                    continue
                assert tdist.local_batch_slice(batch, n, i) == \
                    jdist.local_batch_slice(batch, n, i)
    for devices in (1, 2, 4, 8):
        for d, f, t in ((-1, 1, 1), (-1, 2, 1), (-1, 1, 2), (2, 2, 2), (4, 1, 2), (1, 8, 1)):
            try:
                want = JMeshConfig(data=d, fsdp=f, tensor=t).resolved(devices)
            except (AssertionError, ValueError):  # the port refuses it with a ValueError
                with pytest.raises(ValueError):
                    MeshConfig(data=d, fsdp=f, tensor=t).resolved(devices)
                continue
            got = MeshConfig(data=d, fsdp=f, tensor=t).resolved(devices)
            assert (got.data, got.fsdp, got.tensor) == (want.data, want.fsdp, want.tensor)


def test_one_process_needs_no_launcher_and_still_needs_a_card(monkeypatch, tmp_path):
    import torch

    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not tdist.maybe_init_distributed("cpu")
    assert not tdist.maybe_init_distributed("cpu")  # a second call: still a no-op
    assert not torch.distributed.is_initialized()
    mesh = tdist.make_mesh(MeshConfig(), "cpu")
    assert not mesh.distributed and mesh.rank == 0 and mesh.world == 1
    assert mesh.local_rows(np.arange(4)).tolist() == [0, 1, 2, 3]
    assert tdist.on_main(lambda a: a + 1, 1) == 2
    x = torch.ones(3, requires_grad=True)
    assert tdist.all_reduce_sum(x) is x  # no group: unchanged
    model = LDiffusionModel("random:tiny", "tissue", device="cpu", work_dir=str(tmp_path))
    assert model.device == torch.device("cpu") and not model.mesh.distributed
    if not torch.cuda.is_available():  # the entry points raise without a card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LDiffusionModel("random:tiny", "tissue")
        plan = SegPlan(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16),
                       strides=(1, 2), n_conv_per_stage=2, num_classes=2, in_channels=3,
                       normalization="zscore_image", intensity_properties={},
                       median_shape=(32, 32), batch_dice=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SegmentorTrainer(plan, SegmentorTrainConfig(), output_dir=str(tmp_path / "s"))


def test_mesh_groups_hold_their_ranks(tmp_path):
    """Four gloo ranks. A (data=2, tensor=2) mesh (rank = 2·d + t): its
    ``group``, which its barrier waits on, holds every rank; each batch
    group the ranks of one tensor coordinate, which share rows. A mesh over
    ranks 0 and 1 (the segmentor CLI's ``gcd`` subgroup): its collectives
    complete without ranks 2 and 3, which are not members."""
    ranks = rank_outputs(spawn_ranks("mesh", 4, tmp_path), tmp_path, timeout=120)
    for r, out in enumerate(ranks):
        assert out["group"].tolist() == [0, 1, 2, 3]
        assert out["batch_group"].tolist() == [r % 2, r % 2 + 2]
        assert out["rows"].tolist() == [4 * (r // 2), 4 * (r // 2) + 4]
        assert float(out["batch_sum"]) == 2 * (r % 2) + 2
        assert bool(out["member"]) == (r < 2)
        if r < 2:
            assert out["sub_group"].tolist() == [0, 1]
            assert float(out["sub_sum"]) == 1.0


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_stage1_step_matches_jax_on_a_mesh_of_the_same_shape(world, layout):
    run = world[MESHES[layout]]
    rank0 = run["ranks"][0]
    assert float(rank0["loss"]) == pytest.approx(run["jax"]["loss"], rel=LOSS_TOL)
    assert_step_close(rank0, run["jax"], GRAD_TOL, NU_TOL, PARAM_TOL, world["lr"])


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_stage1_step_matches_one_process(world, layout):
    one, ranks = world["one"], world[MESHES[layout]]["ranks"]
    for r in ranks:  # every rank holds the same global loss and norm, and gathers the same state
        assert float(r["loss"]) == pytest.approx(one["loss"], rel=PORT_LOSS_TOL)
        assert float(r["norm"]) == pytest.approx(one["norm"], rel=PORT_LOSS_TOL)
        assert_step_close(r, one, PORT_GRAD_TOL, PORT_NU_TOL, PORT_PARAM_TOL, world["lr"])
    for k, v in ranks[0].items():
        if k.startswith("param/"):
            np.testing.assert_array_equal(ranks[1][k], v)


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_checkpoint_round_trips_bit_equal(world, layout):
    run = world[MESHES[layout]]
    ranks = run["ranks"]
    # fsdp=2 shards every parameter; replication keeps each whole
    assert all(bool(r["sharded"]) == (layout == "sharded") for r in ranks)
    assert all(bool(r["roundtrip_equal"]) for r in ranks)  # re-sharded bit-equal
    ck = j_load_pytree(os.path.join(str(run["root"]), "state.pkl"))  # a plain pickle.load
    assert int(ck["step"]) == int(ck["opt_state"]["count"]) == 1
    for kind, tree in (("param", ck["params"]), ("mu", ck["opt_state"]["mu"]),
                       ("nu", ck["opt_state"]["nu"])):
        for k, v in flat(tree).items():
            np.testing.assert_array_equal(v, ranks[0][f"{kind}/{k}"])
