"""The port's diffusion transform and sliding-window predictor against the
JAX package's, on the same weights and numpy inputs, at f32.

Tolerances: the scheduler's arithmetic is the same float32 scalar math on
the same tensors (1e-6); the one-step transform and the predictor's logits run
a whole tiny network stack in another summation order (max abs 1e-3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu.diffusion.schedulers import PNDMScheduler as JPNDM
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.segmentor import predictor as jpred
from ldiffusion_tpu.segmentor.planner import SegPlan as JSegPlan
from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
from ldiffusion_tpu_torch.diffusion.schedulers import PNDMScheduler
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.segmentor import predictor as tpred
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from torch_port_common import jax_random_components
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

SCHED_TOL = 1e-6
NET_TOL = 1e-3


@pytest.mark.parametrize("steps", [1, 5])
def test_pndm_matches_jax(steps):
    jsch, tsch = JPNDM(), PNDMScheduler()
    np.testing.assert_array_equal(tsch.schedule.alphas_cumprod, jsch.schedule.alphas_cumprod)
    assert tsch.schedule.final_alpha_cumprod == jsch.schedule.final_alpha_cumprod
    jts, ts = jsch.set_timesteps(steps), tsch.set_timesteps(steps)
    assert ts.values == jts.values and ts.step_ratio == jts.step_ratio
    if steps == 1:  # one step visits t=1 and steps to prev_t = 1 - 1000 → final alpha
        assert ts.values == (1,)
    rng = np.random.default_rng(0)
    sample = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    jstate, tstate = jsch.init_state(sample.shape), tsch.init_state()
    for t in ts.values:
        eps = rng.normal(size=sample.shape).astype(np.float32)
        jsample, jstate = jsch.step(jts, jstate, jnp.asarray(eps), jnp.int32(t), jsample)
        tsample, tstate = tsch.step(ts, tstate, torch.from_numpy(eps), t, tsample)
        np.testing.assert_allclose(tsample.numpy(), np.asarray(jsample), atol=SCHED_TOL,
                                   rtol=SCHED_TOL)
    assert tstate.counter == len(ts.values)


@pytest.fixture(scope="module")
def jax_components():
    return jax_random_components()


def test_one_step_transform_matches_jax(jax_components):
    jc = jax_components
    img = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jemb = jpipe.trajectory_text_emb(jc, jc.params, 1)
    ref = jax.jit(lambda p, x: jpipe.one_step_transform(jc, p, x, jemb))(jc.params,
                                                                          jnp.asarray(img))
    comps = tpipe.SDComponents.from_flax(jc.params, device="cpu")
    with torch.inference_mode():
        emb = tpipe.trajectory_text_emb(comps, 1)
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=NET_TOL)
        out = tpipe.one_step_transform(comps, torch.from_numpy(img), emb).numpy()
    assert out.shape == (1, 64, 64, 3)
    assert float(np.max(np.abs(out - np.asarray(ref)))) < NET_TOL


_PLAN = dict(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
             strides=(1, 2, 2), n_conv_per_stage=2, num_classes=7, in_channels=3,
             normalization="zscore_image", intensity_properties={}, median_shape=(64, 64),
             batch_dice=True)


def test_compute_steps_and_gaussian_match_jax():
    for size, patch in ((64, 32), (100, 32), (32, 32), (1024, 1024), (1300, 1024)):
        assert tpred.compute_steps(size, patch) == jpred.compute_steps(size, patch)
    # bit-equal: the port takes the outer product of the 2D filter's 1D passes
    for patch in ((32, 32), (48, 64), (33, 47), (255, 256), (1024, 1024)):
        np.testing.assert_array_equal(tpred.gaussian_importance_map(patch),
                                      jpred.gaussian_importance_map(patch))


def test_sliding_window_logits_match_jax():
    """64² image, 32² patch: 9 tiles, 4-way mirror TTA, gaussian blending."""
    jplan = JSegPlan(**_PLAN)
    params = JDynUNet(jplan.network_config()).init(jax.random.key(3),
                                                   jnp.zeros((1, 32, 32, 3)))["params"]
    img = np.random.default_rng(2).random((64, 64, 3)).astype(np.float32)
    ref = jpred.SlidingWindowPredictor(jplan, params, dtype=jnp.float32).predict_logits(img)
    plan = SegPlan(**_PLAN)
    port = tpred.SlidingWindowPredictor(plan, dynunet_from_flax(params, plan.network_config()),
                                        dtype=torch.float32, device="cpu")
    assert len(tpred.compute_steps(64, 32)) ** 2 == 9
    out = port.predict_logits(img)
    assert out.shape == (64, 64, 7)
    assert float(np.max(np.abs(out - ref))) < NET_TOL
    np.testing.assert_array_equal(port.predict(img), out.argmax(-1).astype(np.uint8))
