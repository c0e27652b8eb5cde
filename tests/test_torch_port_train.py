"""Stage-1 Laplace warm-up training of the port against the JAX package's, on
the CPU at the tiny configs in f32, from the same weights.

Randomness cannot be shared (``jax.random.laplace`` and the Gumbel draws of
the contrastive sampler have no torch counterpart), so the JAX package's
noise and contrastive indices are drawn from its keys, along its own
``split`` sequence, and handed to the port.

The trajectory features and the loss over 12 steps are in
``test_torch_port_trajectory.py`` and ``test_torch_port_train_loss.py`` (each
of the three slow tests in a file of its own, so the suite's workers share
them); the set-up is ``torch_port_common``'s.

Tolerances (f32 on both sides; only the order of sums differs, through the
UNet, the VAE decoder, VGG19 and their backward passes):
- one train step, and the same step through the function its program
  captures (``step_fn`` by way of ``train_step``, with the JAX draws), whose
  gradient norm is held to optax's ``global_norm`` at the loss's 1e-5 and
  whose clipped gradients to the JAX gradients times 1/norm at 1e-4: the loss 1e-5 relative; each gradient tensor and the AdamW
  first moment (``mu``, 0.1·g after one step) within 1e-4 of the tensor's
  largest value, the second moment (``nu``, 0.001·g²) within 2e-4 (measured:
  1.6e-5, 1.6e-5, 3.1e-5). torch's ``clip_grad_norm_`` divides by the norm
  + 1e-6 where optax's ``clip_by_global_norm`` divides by the norm: at this
  step's norm (~17) that is 6e-8 relative, far inside them. Updated
  parameters agree to 2e-7 wherever the gradient exceeds 1e-3 of its tensor's
  largest value; below that, Adam's first step g/(|g| + eps) is decided by
  gradient bits under the tolerance, so there they are held only to the
  largest first step, 2·lr;
- ``save_unet_dir`` round trips: the UNet output on the same input, 1e-3 (the
  models' own parity tolerance, ``test_torch_port_models``).
"""
import argparse
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from ldiffusion_tpu.core.config import DiffusionTrainConfig as JConfig
from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.data import dataset as jdata
from ldiffusion_tpu.losses.infonce import InfoNceLoss as JInfoNce
from ldiffusion_tpu.models.convert import load_unet_dir as j_load_unet_dir
from ldiffusion_tpu.models.convert import save_unet_dir as j_save_unet_dir
from ldiffusion_tpu.models.unet import UNet2DCondition as JUNet
from ldiffusion_tpu.models.vgg import VGG19Features as JVGG
from ldiffusion_tpu.train.ldiffusion import DiffusionWarmupTrainer as JTrainer
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
from ldiffusion_tpu_torch.data import dataset as tdata
from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise
from ldiffusion_tpu_torch.losses.infonce import ContrastIndices
from ldiffusion_tpu_torch.models.convert import (
    load_unet_dir,
    proj_to_flax,
    save_unet_dir,
    unet_from_flax,
    unet_to_flax,
)
from ldiffusion_tpu_torch.models.unet import UNet2DCondition
from torch_port_common import STAGE1_ANCHORS as ANCHORS
from torch_port_common import STAGE1_CLASSES as CLASSES
from torch_port_common import STAGE1_NEGATIVES as NEGATIVES
from torch_port_common import (
    flat,
    jax_contrast_indices,
    jax_laplace_noise,
    jax_random_components,
    stage1_vgg_params,
)
from torch_port_common import port_stage1_trainer as _port_trainer
from torch_port_common import stage1_data as _data
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NU_TOL = 2e-4
PARAM_TOL = 2e-7
NET_TOL = 1e-3


@pytest.fixture(scope="module")
def jc():
    return jax_random_components()


@pytest.fixture(scope="module")
def jax_vgg_params():
    return stage1_vgg_params()


def test_laplace_noise_has_unit_laplace_moments():
    x = laplace_noise((200000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(x).all()
    assert abs(float(x.mean())) < 0.02 and abs(float(x.var()) - 2.0) < 0.05  # Laplace(0, 1)
    assert abs(float(x.abs().mean()) - 1.0) < 0.01


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def _port_tree(trainer, of):
    """A function of each master tensor, in the JAX package's flax layout."""
    sds = {"unet": {}, "proj": {}}
    for (key, name), m in zip(trainer.names, trainer.master):
        sds[key][name] = of(m)
    return flat({"unet": unet_to_flax(sds["unet"], trainer.c.unet_config),
                 "proj": proj_to_flax(sds["proj"])})


def _close_per_tensor(port, want, tol):
    want = flat(jax.device_get(want))
    assert set(port) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(port[name] - w).max()) <= tol * scale, name


@pytest.fixture(scope="module")
def jax_step(jc, jax_vgg_params):
    """One JAX train step from the components' weights (its loss, gradients,
    AdamW state and parameters), and the noise and contrastive indices its
    ``_loss_fn`` drew: one compile for the tests that hold a port step to it."""
    images, labels = _data()
    mesh = make_mesh(MeshConfig(data=1, fsdp=1), devices=jax.devices()[:1])
    jinfo = JInfoNce(vgg=JVGG(), vgg_params=jax_vgg_params, num_anchors=ANCHORS,
                     num_negatives=NEGATIVES, num_classes=CLASSES)
    # remat only changes what the backward keeps, not the values
    jtr = JTrainer(jc, JConfig(num_inference_steps=10, batch_size=2, num_classes=CLASSES,
                               remat=False), mesh, info_nce=jinfo)
    key = jax.random.key(3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        jtr.state.params, jtr.frozen, jnp.asarray(images), jnp.asarray(labels), key)
    updates, opt_state = jax.jit(jtr.tx.update)(jgrads, jtr.state.opt_state, jtr.state.params)
    jparams = jax.jit(optax.apply_updates)(jtr.state.params, updates)
    k_noise, k_contrast = jax.random.split(key)  # the JAX _loss_fn's split
    return {"images": images, "labels": labels, "loss": float(jloss), "grads": jgrads,
            "adam": _adam_state(opt_state), "params": jparams,
            "noise": jax_laplace_noise(k_noise, 3, (2, 32, 32, 4)),
            "indices": jax_contrast_indices(labels, k_contrast, NEGATIVES, ANCHORS, CLASSES)}


def _held_to_the_jax_update(trainer, jax_step):
    """The AdamW moments and the updated parameters against the JAX step's."""
    state = trainer.opt.state
    adam = jax_step["adam"]
    _close_per_tensor(_port_tree(trainer, lambda m: state[m]["exp_avg"]), adam.mu, GRAD_TOL)
    _close_per_tensor(_port_tree(trainer, lambda m: state[m]["exp_avg_sq"]), adam.nu, NU_TOL)
    params, grads = _port_tree(trainer, lambda m: m), flat(jax.device_get(jax_step["grads"]))
    lr = trainer.cfg.learning_rate
    for name, want in flat(jax.device_get(jax_step["params"])).items():
        g = np.abs(grads[name])
        tol = np.where(g > 1e-3 * g.max(), PARAM_TOL, 2 * lr)
        assert (np.abs(params[name] - want) <= tol).all(), name


def test_train_step_matches_jax(jc, jax_vgg_params, jax_step):
    """One step from the same weights, noise and contrastive indices: loss,
    gradients, AdamW moments and updated parameters."""
    images, labels = jax_step["images"], jax_step["labels"]
    trainer = _port_trainer(jc, jax_vgg_params, num_inference_steps=10, batch_size=2)
    loss, _ = trainer.loss_and_grads(torch.from_numpy(images), torch.from_numpy(labels).long(),
                                     torch.from_numpy(jax_step["noise"]),
                                     ContrastIndices(*(torch.from_numpy(a)
                                                       for a in jax_step["indices"])))
    assert float(loss) == pytest.approx(jax_step["loss"], rel=LOSS_TOL)
    _close_per_tensor(_port_tree(trainer, lambda m: m.grad), jax_step["grads"], GRAD_TOL)

    trainer.apply_update()
    _held_to_the_jax_update(trainer, jax_step)


def test_static_input_step_function_matches_the_jax_step(jc, jax_vgg_params, jax_step,
                                                         monkeypatch):
    """The function the step's program captures, ``step_fn(images,
    labels)`` (the draws, the loss and gradients, the clip, AdamW, the cast
    into the modules), with the JAX step's draws in place of the
    generator's, through ``train_step`` (on the CPU its program calls it):
    the loss, the gradient norm (optax's ``global_norm``), the clipped
    gradients, the AdamW moments and the updated parameters."""
    images, labels = jax_step["images"], jax_step["labels"]
    trainer = _port_trainer(jc, jax_vgg_params, num_inference_steps=10, batch_size=2)
    draws = (torch.from_numpy(jax_step["noise"]),
             ContrastIndices(*(torch.from_numpy(a) for a in jax_step["indices"])))
    monkeypatch.setattr(trainer, "draw", lambda images, labels: draws)
    metrics = trainer.train_step(images, labels)
    assert trainer.steps_done == 1 and len(trainer.history) == 1
    assert metrics["loss"] == pytest.approx(jax_step["loss"], rel=LOSS_TOL)
    norm = float(optax.global_norm(jax_step["grads"]))
    assert metrics["grad_norm"] == pytest.approx(norm, rel=LOSS_TOL)
    clipped = jax.tree_util.tree_map(lambda g: g * (trainer.cfg.grad_clip / norm),
                                     jax_step["grads"])
    _close_per_tensor(_port_tree(trainer, lambda m: m.grad), clipped, GRAD_TOL)
    _held_to_the_jax_update(trainer, jax_step)
    for p, m in zip(trainer.params, trainer.master):  # the masters cast into the modules
        assert torch.equal(p.detach(), m.detach().to(p.dtype))


def _unet_out(params_or_module, config, x, t, ctx):
    if isinstance(params_or_module, UNet2DCondition):
        with torch.no_grad():
            return params_or_module(torch.from_numpy(x).permute(0, 3, 1, 2), t,
                                    torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    unet = JUNet(config)
    return np.asarray(jax.jit(unet.apply)({"params": params_or_module}, jnp.asarray(x),
                                          jnp.int32(t), jnp.asarray(ctx)))


def test_save_unet_dir_round_trips_through_both_packages(jc, tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 5, 32)).astype(np.float32)
    comps = tpipe.SDComponents.from_flax(jc.params, device="cpu")
    # port → JAX
    save_unet_dir(str(tmp_path / "port"), comps.unet_config, comps.unet.state_dict(),
                  comps.proj.state_dict())
    config, params, proj = j_load_unet_dir(str(tmp_path / "port"))
    assert config == jc.unet_config
    np.testing.assert_allclose(_unet_out(params, config, x, 10, ctx),
                               _unet_out(comps.unet, comps.unet_config, x, 10, ctx), atol=NET_TOL)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(proj[k], np.asarray(jc.params["proj"][k]))
    # JAX → port
    j_save_unet_dir(str(tmp_path / "jax"), jc.unet_config, jc.params["unet"],
                    proj=jc.params["proj"])
    pconfig, unet_sd, proj_sd = load_unet_dir(str(tmp_path / "jax"))
    unet = UNet2DCondition(pconfig)
    unet.load_state_dict(unet_sd)
    np.testing.assert_allclose(_unet_out(unet, pconfig, x, 10, ctx),
                               _unet_out(jc.params["unet"], jc.unet_config, x, 10, ctx),
                               atol=NET_TOL)
    assert set(unet_sd) == set(unet_from_flax(jc.params["unet"], pconfig))


def _pairs(root, n=4):
    """n synthetic 64² image/label PNG pairs (labels in the tissue pixel code)."""
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(
            images / f"roi_{i}.png")
        lab = np.zeros((64, 64), np.uint8)
        lab[:32] = 100
        lab[32:, :32] = 150
        Image.fromarray(lab).save(labels / f"roi_{i}.png")
    return argparse.Namespace(image_dir=str(images), label_dir=str(labels), batch_size=1,
                              num_inference_steps=5, num_classes=7, num_epochs=1)


def test_dataset_split_labels_and_batches_match_jax(tmp_path):
    args = _pairs(tmp_path, n=5)
    pairs = tdata.list_pairs(args.image_dir, args.label_dir)
    assert pairs == jdata.list_pairs(args.image_dir, args.label_dir)
    split = tdata.split_dataset(*pairs, 0.7, 0)
    assert split == jdata.split_dataset(*pairs, 0.7, 0)
    port = tdata.SegmentationDataset(split[0], split[1], "tissue").iter_batches(2, 64, 32)
    ref = jdata.SegmentationDataset(split[0], split[1], "tissue").iter_batches(2, 64, 32)
    for _ in range(3):  # across a reshuffle: 3 pairs give one batch of 2 per pass
        (im, lab), (jim, jlab) = next(port), next(ref)
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(lab, jlab)
        assert lab.dtype == np.int32 and lab.shape == (2, 32, 32) and set(np.unique(lab)) <= {0, 1, 2}


def test_api_trains_ldiffusion_and_saves_a_readable_unet(jc, tmp_path):
    args = _pairs(tmp_path)
    comps = tpipe.SDComponents.from_flax(jc.params, device="cpu")
    cfg = DiffusionTrainConfig(num_epochs=1, num_inference_steps=5, num_classes=7,
                               compute_dtype="float32")
    model = LDiffusionModel("random:tiny", "tissue", components=comps, device="cpu",
                            work_dir=str(tmp_path / "work"), diffusion_config=cfg)
    with pytest.raises(ValueError, match="ldiffusion_weight"):
        model.train(args, component="segmentor")  # stage 2 alone needs a UNet
    assert not (tmp_path / "work").exists()  # refused before any training
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        out = model.train(args, component="ldiffusion")
    assert model.trainer.steps_done == 2  # int(4 * 0.7) = 2 training pairs, batch 1
    config, unet_sd, _ = load_unet_dir(out["ldiffusion"])
    sd = model.trainer.state_dicts()["unet"]
    assert all(torch.equal(unet_sd[k], sd[k]) for k in sd)
    csv = (tmp_path / "work" / "loss").rglob("contrast_loss.csv")
    rows = next(csv).read_text().splitlines()
    assert rows[0] == "epoch,loss" and len(rows) == 2
    assert config == comps.unet_config and os.path.exists(
        os.path.join(out["ldiffusion"], "proj_weights.npz"))
