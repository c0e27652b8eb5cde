"""The port's 3D network and N-D sliding-window predictor against the JAX
package's, on the CPU at tiny sizes in float32: ``DynUNet3D`` plain and
residual (every deep-supervision head, flax parameters carried both ways by
``dynunet3d_from_flax`` / ``dynunet3d_to_flax``), the 3D gaussian importance
map and tile steps, and ``SlidingWindowPredictor`` on a 3D plan (8-flip
mirror TTA and a restricted axis set, two folds, a label manager, volumes
smaller and larger than the patch).

Tolerances (float32 on both sides; only the order of sums differs):
- every head of the training and inference forward: 1e-5 of the largest
  value;
- parameters carried back: equal; the gaussian map and the steps: equal;
- the predictor's logits: 1e-4 of the largest logit; masks: 100% equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu.models.dynunet3d import DynUNet3D as JNet
from ldiffusion_tpu.models.dynunet3d import DynUNet3DConfig as JConfig
from ldiffusion_tpu.segmentor import predictor as jpred
from ldiffusion_tpu.segmentor.label_manager import LabelManager as JLabelManager
from ldiffusion_tpu.segmentor.planner3d import SegPlan3D as JPlan
from ldiffusion_tpu_torch.models.convert import dynunet3d_from_flax, dynunet3d_to_flax, flatten_tree
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3D, DynUNet3DConfig
from ldiffusion_tpu_torch.segmentor import predictor as tpred
from ldiffusion_tpu_torch.segmentor.label_manager import LabelManager
from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

NET_TOL = 1e-5
LOGIT_TOL = 1e-4
PLAN = dict(patch_size=(8, 16, 16), batch_size=2, spacing=(1.0, 1.0, 1.0),
            features_per_stage=(8, 16, 32), strides=((1, 1, 1), (2, 2, 2), (1, 2, 2)),
            kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3)), n_conv_per_stage=2,
            num_classes=3, in_channels=2, normalization="zscore", median_shape=(10, 20, 20),
            batch_dice=False)


def _init(cfg, shape):
    net = JNet(cfg)
    return net, jax.jit(net.init)(jax.random.key(0), jnp.zeros(shape))["params"]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("block_type", ["plain", "residual"])
def test_dynunet3d_matches_flax_on_every_head(block_type):
    jcfg = dataclasses.replace(JConfig.tiny(num_classes=3, in_channels=2), block_type=block_type,
                               n_blocks_per_stage=(1, 2, 2) if block_type == "residual" else (),
                               kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3)))
    cfg = DynUNet3DConfig(**dataclasses.asdict(jcfg))
    jnet, params = _init(jcfg, (1, 8, 16, 16, 2))
    x = np.random.default_rng(0).normal(size=(2, 8, 16, 16, 2)).astype(np.float32)
    want = jax.jit(lambda p, v: jnet.apply({"params": p}, v, train=True))(params, jnp.asarray(x))
    net = DynUNet3D(cfg)
    net.load_state_dict(dynunet3d_from_flax(params, cfg))
    xt = torch.from_numpy(x).movedim(-1, 1)
    got = net(xt, train=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.movedim(1, -1).detach().numpy(), w) <= NET_TOL
    # inference returns the full-resolution head alone (flax: ``seg_outputs[0]``)
    assert _rel(net(xt).movedim(1, -1).detach().numpy(), want[0]) <= NET_TOL
    back = flatten_tree(dynunet3d_to_flax(net.state_dict(), cfg))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    if block_type == "residual":
        assert "downsample_conv" in params["enc_1_0"] and "enc_2_1" in params
    # bf16 compute over f32 parameters: the parameters stay f32, the heads are f32
    net.compute_dtype = torch.bfloat16
    out = net(xt, train=True)
    assert net.seg_0.weight.dtype == torch.float32 and out[0].dtype == torch.float32
    assert float((out[0] - got[0]).detach().abs().max()) < 0.1


def test_gaussian_map_and_steps_equal_jax():
    for patch in ((8, 16, 16), (7, 12, 9), (80, 128, 128), (112, 96, 96), (32, 48)):
        np.testing.assert_array_equal(tpred.gaussian_importance_map(patch),
                                      jpred.gaussian_importance_map(patch))
    for args in ((160, 80, 0.5), (127, 112, 0.5), (203, 96, 0.5), (10, 16, 0.5), (50, 16, 0.3)):
        assert tpred.compute_steps(*args) == jpred.compute_steps(*args)


@pytest.fixture(scope="module")
def folds():
    """Two folds' flax parameters of the tiny 3D plan."""
    jnet = JNet(JPlan(**PLAN).network_config())
    init = jax.jit(jnet.init)
    return [init(jax.random.key(s), jnp.zeros((1, 8, 16, 16, 2)))["params"] for s in (1, 2)]


@pytest.mark.parametrize("case", ["two_folds_8_flips", "restricted_axes", "small_volume",
                                  "label_manager"])
def test_predictor_matches_jax(folds, case):
    rng = np.random.default_rng(3)
    shape = (5, 12, 14) if case == "small_volume" else (11, 23, 29)
    image = rng.normal(size=shape + (2,)).astype(np.float32) * 3 + 1
    params = folds if case == "two_folds_8_flips" else folds[:1]
    kw = {"mirror_axes": (0, 2)} if case == "restricted_axes" else {}
    tl = jl = None
    if case == "label_manager":
        labels = {"background": 0, "a": 1, "b": 3}
        tl, jl = LabelManager(labels), JLabelManager(labels)
    jp = jpred.SlidingWindowPredictor(JPlan(**PLAN), list(params), dtype=jnp.float32,
                                      label_manager=jl, **kw)
    cfg = SegPlan3D(**PLAN).network_config()
    tp = tpred.SlidingWindowPredictor(SegPlan3D(**PLAN),
                                      [dynunet3d_from_flax(p, cfg) for p in params],
                                      dtype=torch.float32, device="cpu", label_manager=tl, **kw)
    want = jp.predict_logits(image)
    got = tp.predict_logits(image)
    assert got.shape == shape + (3,)
    assert _rel(got, want) <= LOGIT_TOL
    # the JAX predictor's mask is this conversion of its logits, on the device
    mask = jl.convert_logits_to_segmentation(want) if jl is not None else want.argmax(-1)
    np.testing.assert_array_equal(tp.predict(image), mask)
    probs = tp.predict_probabilities(image)
    jprobs = jl.apply_inference_nonlin(want) if jl is not None else \
        np.asarray(jax.nn.softmax(want, axis=-1))
    np.testing.assert_allclose(probs, jprobs, atol=LOGIT_TOL)
    padded = [max(p, s) for p, s in zip(PLAN["patch_size"], shape)]
    tiles = int(np.prod([len(tpred.compute_steps(n, p)) for n, p in
                         zip(padded, PLAN["patch_size"])]))
    flips = 4 if case == "restricted_axes" else 8
    # predict_logits, predict and predict_probabilities each ran every fold once
    assert tp.network_forwards == 3 * tiles * flips * len(params)
