"""Resuming the port's segmentor trainer from a checkpoint of the JAX trainer
(its optax ``opt_state``), on the CPU in float32, for the SGD, Adam and Adan
recipes: the JAX trainer takes two optimizer steps and saves; the port and
a fresh JAX trainer each load that checkpoint and take one more step on the
same gradients.

Tolerances (float32 on both sides; only the order of sums differs):
parameters and optimizer buffers within 5e-5 of each tensor's largest value
(the stage-2 step tolerance of ``test_torch_port_seg_train`` and
``test_torch_port_seg_variants``); a buffer of a conv bias in front of an
InstanceNorm is rounding noise and is held to 5e-5 absolutely; the learning
rate, step, epoch and logger exactly.
"""
import os

import numpy as np
import pytest
import torch

import jax
import optax

from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.config import SegmentorTrainConfig as JConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor import variants as jvar
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu_torch.core.checkpoint import load_pytree
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor import variants as tvar
from ldiffusion_tpu_torch.segmentor.planner import SegPlan

STEP_TOL = 5e-5
PLAN = dict(patch_size=(16, 16), batch_size=2, features_per_stage=(4, 8), strides=(1, 2),
            n_conv_per_stage=2, num_classes=3, in_channels=3, normalization="zscore_image",
            intensity_properties={}, median_shape=(16, 16), batch_dice=True)
BASE = dict(compute_dtype="float32", weight_decay=0.1)
# the optax state of each recipe, and its buffer fields in the port's names
JAX_BUFFERS = {"sgd": ("TraceState", {"trace": "momentum_buffer"}),
               "adam": ("ScaleByAdamState", {"mu": "exp_avg", "nu": "exp_avg_sq"}),
               "adan": ("AdanState", {"m": "m", "v": "v", "n": "n", "prev_grad": "prev_grad"})}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _find(state, cls):
    """The optax sub-state named ``cls`` inside the JAX optimizer state."""
    if type(state).__name__ == cls:
        return state
    children = state if isinstance(state, (tuple, list)) else \
        [getattr(state, f) for f in getattr(state, "_fields", ())]
    for child in children:
        if isinstance(child, (tuple, list)) or hasattr(child, "_fields"):
            found = _find(child, cls)
            if found is not None:
                return found
    return None


def _grads(rng, params, scale):
    return jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * scale)
                                  .astype(np.float32), params)


def _held(got: dict, want: dict, what: str):
    for k, ref in want.items():
        scale = max(float(ref.abs().max()), 1.0 if k.endswith(".conv.bias") else 1e-30)
        err = float((got[k] - ref).abs().max()) / scale
        assert err <= STEP_TOL, (what, k, err)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


@pytest.mark.parametrize("name", ["nnUNetTrainer", "nnUNetTrainerAdam", "nnUNetTrainerAdan"])
def test_port_resumes_the_jax_optax_state(name, mesh, tmp_path):
    jv = jvar.get_variant(name, base=JConfig(**BASE))
    tv = tvar.get_variant(name, base=SegmentorTrainConfig(**BASE))
    rng = np.random.default_rng(4)
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), jv.config, mesh,
                                    output_dir=str(tmp_path / "j"), variant=jv)
    params, opt_state = jax.tree_util.tree_map(np.asarray, jtr.state.params), jtr.state.opt_state
    lrs = [jv.config.initial_lr, jv.config.initial_lr * 0.9, jv.config.initial_lr * 0.8]
    for k, scale in enumerate((5.0, 0.3)):  # k = 2 steps, the first one clipped
        updates, opt_state = jtr.tx.update(_grads(rng, params, scale),
                                           jtrainer._set_lr(opt_state, lrs[k]), params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    jtr.state = jtr.state._replace(params=params, opt_state=opt_state,
                                   step=jax.numpy.asarray(2, jax.numpy.int32))
    jtr.current_epoch, jtr.best_ema = 1, 0.25
    jtr.epoch_log.log("lr", lrs[1], 0)
    path = str(tmp_path / "checkpoint_latest.pkl")
    jtr.save_checkpoint(path)

    # the port reads the optax state through its stand-ins
    cfg = SegPlan(**PLAN).network_config()
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), tv.config, output_dir=str(tmp_path / "t"),
                                   variant=tv, device="cpu")
    tr.load_checkpoint(path)
    assert tr.opt.param_groups[0]["lr"] == float(np.float32(lrs[1]))
    assert (tr.step, tr.current_epoch, tr.best_ema) == (2, 1, 0.25)
    assert tr.epoch_log.state_dict() == load_pytree(path)["logger"]
    cls, fields = JAX_BUFFERS[tv.optimizer]
    saved = _find(opt_state, cls)
    for field, buf in fields.items():  # the buffers arrive as they were
        want = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, getattr(saved, field)), cfg)
        for k, v in tr._opt_buffers(buf).items():
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=f"{buf} {k}")

    # one more step in each package from the same checkpoint
    jtr2 = jtrainer.SegmentorTrainer(JPlan(**PLAN), jv.config, mesh,
                                     output_dir=str(tmp_path / "j2"), variant=jv)
    jtr2.load_checkpoint(path)
    grads = _grads(rng, params, 0.5)
    lr = tr.opt.param_groups[0]["lr"]
    updates, opt3 = jtr2.tx.update(grads, jtrainer._set_lr(jtr2.state.opt_state, lr),
                                   jtr2.state.params)
    params3 = jax.tree_util.tree_map(np.asarray,
                                     optax.apply_updates(jtr2.state.params, updates))
    tgrads = dynunet_from_flax(grads, cfg)
    for k, p in tr.net.named_parameters():
        p.grad = tgrads[k].clone()
    tr.apply_update(lr)
    _held({k: p.detach() for k, p in tr.net.named_parameters()},
          dynunet_from_flax(params3, cfg), "params")
    stepped = _find(opt3, cls)
    for field, buf in fields.items():
        want = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, getattr(stepped, field)), cfg)
        _held(tr._opt_buffers(buf), want, buf)


def test_another_optimizer_family_raises(mesh, tmp_path):
    """An SGD checkpoint of the JAX trainer cannot resume an Adam recipe, in
    either package: the port raises naming both."""
    jv = jvar.get_variant("nnUNetTrainer", base=JConfig(**BASE))
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), jv.config, mesh,
                                    output_dir=str(tmp_path / "j"), variant=jv)
    path = str(tmp_path / "ck.pkl")
    jtr.save_checkpoint(path)
    tv = tvar.get_variant("nnUNetTrainerAdam", base=SegmentorTrainConfig(**BASE))
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), tv.config, output_dir=str(tmp_path / "t"),
                                   variant=tv, device="cpu")
    with pytest.raises(NotImplementedError, match="ScaleByAdamState.*TraceState"):
        tr.load_checkpoint(path)
    assert os.path.exists(path)
