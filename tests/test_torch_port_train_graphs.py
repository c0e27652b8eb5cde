"""The step functions the training programs capture (``core/graphs.py``,
``SegmentorTrainer.step_fn``, ``core/optim.py``, the capture-safe sampler
and DA) against the JAX package's jitted steps, on the CPU in float32. On
the CPU a program runs its function eagerly, so ``train_step`` here is the
step function at every call; the card tests and ``chip_smoke.py`` hold the
captured replays to it.

Tolerances (float32 on both sides; only the order of sums differs):
- three segmentor steps through ``train_step`` (the learning rate changed
  between them and handed to the step as a 0-d tensor, as ``_set_lr`` hands
  it to the JAX step) for SGD, Adam and Adan: parameters and the optimizer's
  first buffer within 5e-5 of each tensor's largest value, the losses 5e-5
  relative (the resume tests' bound, ``test_torch_port_resume``). A conv
  bias in front of an InstanceNorm has a gradient of 0 in exact arithmetic,
  so its gradient is rounding noise: SGD moves it by lr times that noise,
  held to 5e-5 absolutely; an adaptive step (Adam, Adan) divides the noise
  by its own scale and moves the bias by up to about lr a step, in a
  direction the noise decides, so under those two its value is held to 2·Σ
  lr (each package's largest movement; measured 0.25 and 0.66 of Σ lr) and
  its buffers are not compared;
- Adan alone over 3 steps against ``ldiffusion_tpu/core/optim.py:adan``:
  1e-6 of each tensor's largest value (the same formulas; the port divides
  the parameter where optax adds a difference);
- DA5's median path on the JAX stack's own draws: 1e-5 absolute (a median
  selects a value; the stack around it is off);
- ``sample_contrast_indices``: bit-equal to the boolean-index sampler it
  replaced, for a seeded generator.
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
from ldiffusion_tpu.core.optim import adan as jadan
from ldiffusion_tpu.data import augment as jaug
from ldiffusion_tpu.data.augment import AugmentConfig as JAugment
from ldiffusion_tpu.segmentor import trainer as jtrainer
from ldiffusion_tpu.segmentor import variants as jvar
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.core.optim import ADAN_BUFFERS, Adan
from ldiffusion_tpu_torch.data import augment as taug
from ldiffusion_tpu_torch.data.augment import AugmentConfig
from ldiffusion_tpu_torch.losses import infonce as tinfo
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.segmentor import trainer as ttrainer
from ldiffusion_tpu_torch.segmentor import variants as tvar
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from torch_port_common import jax_draws

STEP_TOL = 5e-5
ADAN_TOL = 1e-6
MEDIAN_TOL = 1e-5
PLAN = dict(patch_size=(16, 16), batch_size=2, features_per_stage=(4, 8), strides=(1, 2),
            n_conv_per_stage=2, num_classes=3, in_channels=3, normalization="zscore_image",
            intensity_properties={}, median_shape=(16, 16), batch_dice=True)
NO_DA = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
             p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)
# each recipe's optax state and its first buffer, in the port's names
FIRST_BUFFER = {"sgd": ("TraceState", "trace", "momentum_buffer"),
                "adam": ("ScaleByAdamState", "mu", "exp_avg"),
                "adan": ("AdanState", "m", "m")}


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


def _held(got: dict, want: dict, what: str, noise_bound=None):
    """Each tensor within STEP_TOL of its largest value; a conv bias in
    front of a norm within STEP_TOL absolutely, or within ``noise_bound``
    absolutely (skipped when it is 0: a buffer of an adaptive step)."""
    for k, ref in want.items():
        noise = k.endswith(".conv.bias")
        if noise and noise_bound is not None:
            if noise_bound:
                assert float((got[k] - ref).abs().max()) <= noise_bound, (what, k)
            continue
        scale = max(float(ref.abs().max()), 1.0 if noise else 1e-30)
        err = float((got[k] - ref).abs().max()) / scale
        assert err <= STEP_TOL, (what, k, err)


@pytest.mark.parametrize("name", ["nnUNetTrainer", "nnUNetTrainerAdam", "nnUNetTrainerAdan"])
def test_segmentor_steps_with_a_changing_lr_match_the_jax_step(name, tmp_path):
    """Three steps of the whole step function (DA off, so the draws do not
    matter; the labels hold crop padding), the learning rate set anew before
    each, against the JAX trainer's ``_train_step(state, data, seg, key,
    lr)``."""
    base = dict(compute_dtype="float32", weight_decay=0.1)
    jv = jvar.get_variant(name, base=JConfig(**base))
    tv = tvar.get_variant(name, base=SegmentorTrainConfig(**base))
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.SegmentorTrainer(JPlan(**PLAN), jv.config, mesh,
                                    output_dir=str(tmp_path / "j"), augment=JAugment(**NO_DA),
                                    variant=jv)
    cfg = SegPlan(**PLAN).network_config()
    tr = ttrainer.SegmentorTrainer(SegPlan(**PLAN), tv.config, output_dir=str(tmp_path / "t"),
                                   augment=AugmentConfig(**NO_DA), variant=tv, device="cpu")
    tr.net.load_state_dict(dynunet_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), cfg))
    rng = np.random.default_rng(6)
    state = jtr.state
    lrs = [jv.config.initial_lr * f for f in (1.0, 0.7, 0.4)]
    for step, lr in enumerate(lrs):
        data = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
        seg = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
        seg[0, :3] = -1  # crop padding: trains as background
        state, jloss = jtr._train_step(state, jnp.asarray(data), jnp.asarray(seg),
                                       jax.random.key(step), jnp.float32(lr))
        loss = tr.train_step(data, seg, lr=lr)
        assert abs(float(loss) - float(jloss)) <= STEP_TOL * abs(float(jloss)), (step, name)
    assert tr.step == int(state.step) == 3
    assert tr.opt.param_groups[0]["lr"] == lrs[-1]
    adaptive = tr.opt_name != "sgd"
    _held({k: p.detach() for k, p in tr.net.named_parameters()},
          dynunet_from_flax(jax.tree_util.tree_map(np.asarray, state.params), cfg), "params",
          2 * sum(lrs) if adaptive else None)
    cls, field, buf = FIRST_BUFFER[tr.opt_name]
    want = jax.tree_util.tree_map(np.asarray, getattr(_find(state.opt_state, cls), field))
    _held(tr._opt_buffers(buf), dynunet_from_flax(want, cfg), buf, 0.0 if adaptive else None)


def test_adan_on_device_state_matches_the_jax_adan():
    """Three steps at a learning rate held in a 0-d tensor, with decoupled
    decay; one parameter has no gradient and steps on a zero one, as optax
    updates every leaf."""
    rng = np.random.default_rng(8)
    shapes = {"w": (5, 4), "b": (4,), "idle": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr, wd = 0.01, 0.1
    tx = jadan(lr, weight_decay=wd)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Adan(list(params.values()), lr=torch.tensor(lr), weight_decay=wd)
    for scale in (3.0, 0.5, 1.0):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) if k != "idle"
                 else np.zeros(s, np.float32) for k, s in shapes.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = None if k == "idle" else torch.from_numpy(grads[k])
        opt.step()
    assert int(jstate.count) == 3
    for k, p in params.items():
        st = opt.state[p]
        assert float(st["step"]) == 3.0
        for name, got in [("param", p.detach())] + [(b, st[b]) for b in ADAN_BUFFERS]:
            want = np.asarray(jparams[k] if name == "param" else getattr(jstate, name)[k])
            err = float(np.abs(got.numpy() - want).max()) / max(float(np.abs(want).max()),
                                                                1e-30)
            assert err <= ADAN_TOL, (k, name, err)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_da5_median_path_matches_jax_without_a_host_branch(seed):
    """The median alone (every other transform off): each sample's pick and
    size from the JAX stack's draws; a batch where no sample picks it comes
    through unchanged, as one where some do is filtered."""
    cfg = dataclasses.replace(tvar.get_variant("nnUNetTrainerDA5").augment, p_rotation=0.0,
                              p_scaling=0.0, **dict.fromkeys(
                                  ("p_rot90", "p_transpose", "p_noise", "p_blur",
                                   "p_brightness", "p_contrast", "p_lowres", "p_gamma_invert",
                                   "p_gamma", "p_mirror", "p_blank_rect",
                                   "p_brightness_gradient", "p_local_gamma", "p_sharpen"),
                                  0.0), p_median=1.0)
    jcfg = jaug.AugmentConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(3, 12, 12, 2)) * 2).astype(np.float32)
    seg = rng.integers(0, 3, (3, 12, 12)).astype(np.int32)
    key = jax.random.key(seed)
    jd, js = jaug.augment_batch(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    p = jax_draws(key, data.shape, cfg)
    d, s = taug.apply_augment(torch.from_numpy(data).permute(0, 3, 1, 2),
                              torch.from_numpy(seg), p, cfg)
    np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(), np.asarray(jd), atol=MEDIAN_TOL,
                               rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    picked = (p["median_pick"] & p["median_on"]).numpy()
    np.testing.assert_array_equal(d.permute(0, 2, 3, 1).numpy()[~picked], data[~picked])


def _uniform_over_boolean_index(mask, n, generator, replacement=False):
    """The sampler's row weights as they were filled before, with a boolean
    index (a host sync)."""
    w = mask.float()
    w[w.sum(dim=1) == 0] = 1.0
    return torch.multinomial(w, n, replacement=replacement, generator=generator)


@pytest.mark.parametrize("num_classes", [None, 5])
def test_contrast_indices_draw_as_the_boolean_index_sampler(num_classes, monkeypatch):
    """Labels where classes 3 and 4 are absent (their pinned anchors' rows
    are empty) and class 2 holds one pixel (its positives' row is empty)."""
    labels = torch.zeros(2, 16, 16, dtype=torch.long)
    labels[:, 8:] = 1
    labels[1, 0, 0] = 2
    draw = lambda: tinfo.sample_contrast_indices(labels, torch.Generator().manual_seed(11),
                                                 num_negatives=12, num_anchors=8,
                                                 num_classes=num_classes)
    got = draw()
    monkeypatch.setattr(tinfo, "_uniform_over", _uniform_over_boolean_index)
    want = draw()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if num_classes is not None:  # the pinned anchors of the absent classes
        assert not bool(got.valid.all())


def test_programs_hold_their_owner_weakly():
    """A program of an owner's method does not keep the owner alive: with
    the cycle collector off, dropping the last reference frees it (and with
    it the programs and, on a card, their graphs), as it does a tiny
    predictor after a prediction through its bucket's program."""
    import gc
    import weakref

    from ldiffusion_tpu_torch.core.graphs import Jit, TrainProgram
    from ldiffusion_tpu_torch.models.dynunet import DynUNet
    from ldiffusion_tpu_torch.models.layers import init_random_
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    class Owner:
        def __init__(self):
            self.program = Jit(self.step, "cpu", program_type=TrainProgram)

        def step(self, x):
            return x * 2

    plan = SegPlan(**PLAN)
    sd = init_random_(DynUNet(plan.network_config()), torch.Generator().manual_seed(3))
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        owner = Owner()
        assert torch.equal(owner.program(torch.ones(2)), torch.full((2,), 2.0))
        owner_ref = weakref.ref(owner)
        del owner
        pred = SlidingWindowPredictor(plan, [sd.state_dict()], dtype=torch.float32,
                                      device="cpu")
        pred.predict(np.random.default_rng(0).random((20, 20, 3)).astype(np.float32))
        assert len(pred._predict_cache) == 1
        pred_ref = weakref.ref(pred)
        del pred
        assert owner_ref() is None and pred_ref() is None
    finally:
        if was_enabled:
            gc.enable()
