"""The cell level's and the dataset builder's programs (``core/graphs.py``)
against the JAX package's jitted functions, on the CPU at tiny sizes, from
the same numpy inputs and weights: ``DiffusionTransform(batch_size=2)`` with
a padded last chunk, both cell trainers at the ``lr`` the JAX tests pass,
the flow proposer's settings changed between calls through one proposer,
and ``CellTrainer.cache_features`` per image. On the CPU a program calls its
function; the card's checks (replays bit-equal to the eager first use, no
aliasing of cached features, a failed capture raising) are the ``gpu``
tests of ``test_torch_port_kernels.py``.

Tolerances:
- the transform: the one-step transform's parity tolerance (max abs 1e-3,
  ``test_torch_port_pipeline``; a tiny f32 network stack in another
  summation order);
- the flow net's outputs ≤ 1e-4 of their largest value (a 3-stage f32
  DynUNet in another summation order) and its integration: positions ≤ 1e-3 px, the foreground equal, the
  rounded sinks equal on ≥ 99.9% of the foreground (a position within
  rounding of a .5 boundary may round the other way), as in
  ``test_torch_port_cell``;
- two ``FlowNetTrainer`` steps at lr 3e-3: each loss to 1e-5 relative, every
  parameter within 5e-5 of its tensor's largest value (``test_torch_port_cell``'s
  one-step bounds), except the conv biases in front of an InstanceNorm,
  whose exact gradient is 0: Adam turns their rounding noise into a step of
  either sign up to lr, so two trajectories are held to 2·lr a step;
- two ``CellTrainer`` steps at lr 1e-2: each loss to 1e-6 relative
  (``test_torch_port_cell_classifier``), the head within 1e-4 of each
  tensor's largest value and within 2·lr a step (an element whose gradient
  is within rounding of 0 steps by up to lr in either package). At this lr
  the second step moves an element by lr·m̂/√v̂ of two gradients, which
  amplifies their f32 rounding (1e-6 relative) where the two nearly cancel:
  measured up to 5.8e-5 of the tensor's largest value on a few elements,
  the bulk under 1e-5;
- the cached features: ≤ 1e-4 of their largest value (f32 conv stacks in
  another summation order, ``test_torch_port_cell_classifier``).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.cell import classifier as jcls
from ldiffusion_tpu.cell import instance as jinst
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.models.dynunet import DynUNetConfig as JDynUNetConfig
from ldiffusion_tpu.models.resnet import ResNetConfig as JResNetConfig
from ldiffusion_tpu.segmentor.dataset_builder import DiffusionTransform as JDiffusionTransform
from ldiffusion_tpu_torch.cell import classifier as tcls
from ldiffusion_tpu_torch.cell import instance as tinst
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
from ldiffusion_tpu_torch.models.convert import (
    CELL_HEAD_ROWS,
    dynunet_from_flax,
    dynunet_to_flax,
    from_flax,
    resnet_to_flax,
)
from ldiffusion_tpu_torch.models.resnet import ResNetConfig
from ldiffusion_tpu_torch.segmentor.dataset_builder import DiffusionTransform
from torch_port_common import jax_components_of
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

NET_TOL = 1e-3
POS_TOL = 1e-3
FLOW_TOL = 1e-4
SINK_AGREEMENT = 0.999
FLOW_LOSS_RTOL = 1e-5
FLOW_PARAM_TOL = 5e-5
HEAD_LOSS_RTOL = 1e-6
HEAD_TOL = 1e-4
FEATURE_TOL = 1e-4


def test_batched_transform_pads_its_last_chunk_as_jax():
    """Three images through ``DiffusionTransform(batch_size=2)``: two chunks,
    the second zero-padded and its pad row dropped, one program for both."""
    comps = SDComponents.random(device="cpu")
    images = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    tf = DiffusionTransform(comps, batch_size=2)
    got = tf(images)
    want = np.asarray(JDiffusionTransform(jax_components_of(comps), batch_size=2)(images))
    assert got.shape == want.shape == (3, 32, 32, 3) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) < NET_TOL
    assert len(tf.program.programs) == 1  # both chunks, one signature


def _jax_flownet(path, **kw):
    with np.load(path) as z:
        features = tuple(int(f) for f in z["__features__"])
        params = {k: z[k] for k in z.files if k != "__features__"}
    from ldiffusion_tpu_torch.models.convert import unflatten_tree

    cfg = JDynUNetConfig(in_channels=3, num_classes=3, features_per_stage=features,
                         strides=(1,) + (2,) * (len(features) - 1), deep_supervision=False)
    return jinst.FlowNetProposer(params=jax.tree_util.tree_map(jnp.asarray,
                                                               unflatten_tree(params)),
                                 net=JDynUNet(cfg), **kw)


def test_proposer_settings_changed_between_calls_take_effect_as_in_jax():
    """One proposer, its ``n_iter`` and ``prob_threshold`` changed between
    calls: ``follow`` and ``_device_propose`` each give what the JAX package
    computes at the new settings (its ``follow_flows`` jitted with the new
    static ``n_iter``; its ``_device_propose``'s net, sigmoid, integration and
    rounding) and what a fresh proposer gives, one program per setting."""
    from test_proposer_quality import make_case

    img = make_case(np.random.default_rng(3), size=48)[0]
    prop = tinst.FlowNetProposer.load_pretrained("synthetic", device="cpu")
    jprop = _jax_flownet(os.path.join(REPO, "ldiffusion_tpu", "artifacts",
                                      "flownet_synthetic.npz"))
    out = np.asarray(jprop.predict_flows(img))
    got = prop.predict_flows(img)  # the image shape's net program
    assert float(np.abs(got - out).max() / np.abs(out).max()) <= FLOW_TOL
    flows, prob = out[..., :2] / 5.0, np.array(jax.nn.sigmoid(out[..., 2]))
    settings = [(200, 0.5), (3, 0.5), (3, 0.95), (200, 0.5)]
    for n_iter, thr in settings:
        prop.n_iter, prop.prob_threshold = n_iter, thr
        ref = np.asarray(jinst.follow_flows(jnp.asarray(flows), jnp.asarray(prob),
                                            n_iter=n_iter, prob_threshold=thr))
        pos = prop.follow(torch.from_numpy(flows), torch.from_numpy(prob)).numpy()
        assert float(np.abs(pos - ref).max()) <= POS_TOL, (n_iter, thr)
        sink, fg = (t.numpy() for t in prop._device_propose(img))
        j_fg = prob > thr
        np.testing.assert_array_equal(fg, j_fg)
        py = np.clip(np.round(ref[..., 0]), 0, 47).astype(np.int32)
        px = np.clip(np.round(ref[..., 1]), 0, 47).astype(np.int32)
        agree = float(np.mean(sink[j_fg] == (py * 48 + px)[j_fg]))
        assert agree >= SINK_AGREEMENT, (n_iter, thr, agree)
        fresh = tinst.FlowNetProposer(net=prop.net, n_iter=n_iter, prob_threshold=thr)
        for a, b in zip(prop._device_propose(img), fresh._device_propose(img)):
            assert torch.equal(a, b), (n_iter, thr)
    # one program per distinct setting, keyed as jax.jit's static arguments
    assert len(prop.programs["propose"].programs) == 3
    assert len(prop.programs["follow_flows"].programs) == 3
    assert len(prop.programs["net"].programs) == 1


def test_flownet_trainer_steps_at_its_lr_match_jax():
    from test_proposer_quality import make_case

    rng = np.random.default_rng(4)
    lr = 3e-3
    prop = tinst.FlowNetProposer.create(features=(8, 16), device="cpu")
    cfg = prop.net.config
    jprop = jinst.FlowNetProposer(
        params=jax.tree_util.tree_map(jnp.asarray, dynunet_to_flax(prop.net.state_dict(), cfg)),
        net=JDynUNet(JDynUNetConfig(in_channels=3, num_classes=3, features_per_stage=(8, 16),
                                    strides=(1, 2), deep_supervision=False)))
    jtr, ttr = jinst.FlowNetTrainer(jprop, lr=lr), tinst.FlowNetTrainer(prop, lr=lr)
    assert ttr.opt.param_groups[0]["lr"] == lr
    for _ in range(2):
        cases = [make_case(rng, size=32) for _ in range(2)]
        x = np.stack([c[0] for c in cases]).astype(np.float32)
        y = np.stack([jinst.masks_to_flows(c[1]) for c in cases])
        jprop.params, jtr.opt_state, jloss = jtr._step(jprop.params, jtr.opt_state,
                                                       jnp.asarray(x), jnp.asarray(y))
        loss = ttr.step(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(loss - float(jloss)) <= FLOW_LOSS_RTOL * abs(float(jloss))
    want = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, jprop.params), cfg)
    got = dict(prop.net.named_parameters())
    for k, ref in want.items():
        diff = float((got[k].detach() - ref).abs().max())
        if k.endswith(".conv.bias"):  # in front of an InstanceNorm: exact gradient 0
            assert diff <= 2 * lr * 2, k
            continue
        assert diff <= FLOW_PARAM_TOL * float(ref.abs().max()), (k, diff)


class _Fixed:
    def __init__(self, inst):
        self.inst = inst

    def propose(self, image):
        return self.inst


def _instances(rng, size, n):
    inst = np.zeros((size, size), np.int32)
    yy, xx = np.ogrid[:size, :size]
    for k in range(1, n + 1):
        cy, cx = rng.integers(6, size - 6, 2)
        inst[((yy - cy) ** 2 + (xx - cx) ** 2 <= int(rng.integers(3, 7)) ** 2) & (inst == 0)] = k
    return inst


@pytest.fixture(scope="module")
def classifiers():
    """The port's tiny-encoder classifier and the JAX one with its encoder
    (carried by ``resnet_to_flax``) and head (the port's, in the flax
    layout)."""
    tc = tcls.CellSegClassifier(5, encoder_cfg=ResNetConfig.tiny(), device="cpu")
    enc = resnet_to_flax(tc.encoder.state_dict(), ResNetConfig.tiny())
    jc = jcls.CellSegClassifier(5, encoder_cfg=JResNetConfig.tiny(),
                                encoder_variables=jax.tree_util.tree_map(jnp.asarray, enc))
    tc.head.load_state_dict(from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray,
                                                                              jc.head)))
    return tc, jc


def test_cell_trainer_steps_at_its_lr_match_jax(classifiers):
    tc, jc = classifiers
    lr, rng = 1e-2, np.random.default_rng(5)
    head0 = {k: v.clone() for k, v in tc.head.state_dict().items()}
    jtr, ttr = jcls.CellTrainer(jc, lr=lr), tcls.CellTrainer(tc, lr=lr)
    assert ttr.opt.param_groups[0]["lr"] == lr
    head, state = jc.head, jtr.opt_state
    try:
        for _ in range(2):
            feats = rng.normal(size=(32, 2, 2, 64)).astype(np.float32)
            labels = rng.integers(0, 5, 32).astype(np.int32)
            valid = (np.arange(32) < 21).astype(np.float32)
            head, state, jloss = jtr._step(head, state, jnp.asarray(feats), jnp.asarray(labels),
                                           jnp.asarray(valid))
            loss = ttr.step(torch.from_numpy(feats).permute(0, 3, 1, 2),
                            torch.from_numpy(labels), torch.from_numpy(valid))
            assert abs(loss - float(jloss)) <= HEAD_LOSS_RTOL * abs(float(jloss))
        want = from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray, head))
        for k, v in tc.head.state_dict().items():
            diff = float((v - want[k]).abs().max())
            assert diff <= HEAD_TOL * float(want[k].abs().max()), (k, diff)
            assert diff <= 2 * lr * 2, k
    finally:
        tc.head.load_state_dict(head0)  # the module's classifier, as it was


def test_cached_features_of_each_image_match_jax(classifiers):
    """``cache_features`` of two images (one bucket, one program): each
    entry holds its own image's features, the JAX ``_roi_feats_fn`` of it,
    and the two entries differ."""
    tc, jc = classifiers
    rng = np.random.default_rng(6)
    pairs, insts = [], []
    for _ in range(2):
        inst = _instances(rng, 64, 10)
        img = np.full((64, 64, 3), 0.85, np.float32)
        img[inst > 0] = rng.random(3).astype(np.float32) * 0.4
        img += rng.normal(0, 0.03, img.shape).astype(np.float32)
        pairs.append((img, np.where(inst > 0, inst % 4 + 1, 0).astype(np.int32)))
        insts.append(inst)
    ttr = tcls.CellTrainer(tc)
    cache = []
    for pair, inst in zip(pairs, insts):
        tc.proposer = _Fixed(inst)
        cache += ttr.cache_features([pair])
    tc.proposer = tcls.DistanceWatershedProposer()
    assert len(cache) == 2 and cache[0][0].shape == cache[1][0].shape
    assert len(tc.programs["roi_features"].programs) == 1
    assert not torch.equal(cache[0][0], cache[1][0])
    jfeats = jcls.CellTrainer(jc)._roi_feats_fn()
    for (img, _), inst, (feats, labels, valid) in zip(pairs, insts, cache):
        ids, boxes = tcls.extract_instance_boxes(inst)
        want = np.asarray(jfeats(jc.encoder_vars, jnp.asarray(img), jnp.asarray(
            tc.pad_boxes(boxes)))).transpose(0, 3, 1, 2)
        err = float(np.abs(feats.numpy() - want).max() / np.abs(want).max())
        assert err <= FEATURE_TOL, err
        assert int(valid.sum()) == len(ids)
