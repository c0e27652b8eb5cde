"""The port's instance proposers and instance metrics against the JAX
package's (``ldiffusion_tpu/cell/instance.py``, ``evaluate.py``), on the
same numpy inputs and weights.

Tolerances: the host pieces (watershed, ``masks_to_flows``, clustering, PQ,
AJI, the folder report) are the same numpy/scipy code: equal. The flow
integration is the same f32 arithmetic in another order: positions ≤ 1e-3 px
after up to 200 steps, and the rounded sinks equal on ≥ 99.9% of foreground
pixels (a position within rounding of a .5 boundary may round the other
way), which must leave the instance maps at PQ ≥ 0.99 against each other.
The flow net's outputs ≤ 1e-4 of their largest value (a 3-stage f32 DynUNet,
another summation order). One AdamW step: the loss to 1e-5 relative, every
parameter ≤ 5e-5 of its tensor's largest value, except the conv biases in
front of an InstanceNorm, whose exact gradient is 0 (the norm removes the
mean): their gradients are rounding noise (≤ 1e-6 in both packages), which
Adam normalises into a step of either sign up to lr, so they are held to
their gradient's bound and to a step ≤ lr.
"""
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from ldiffusion_tpu import evaluate as jeval
from ldiffusion_tpu.cell import instance as jinst
from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.models.dynunet import DynUNetConfig as JDynUNetConfig
from ldiffusion_tpu_torch import evaluate as teval
from ldiffusion_tpu_torch.cell import instance as tinst
from ldiffusion_tpu_torch.models.convert import (
    dynunet_from_flax,
    dynunet_to_flax,
    unflatten_tree,
)
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "tests"))
ARTIFACTS = os.path.join(REPO, "ldiffusion_tpu", "artifacts")

POS_TOL = 1e-3
SINK_AGREEMENT = 0.999
PQ_AGREEMENT = 0.99
FLOW_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_TOL = 5e-5
NOISE_GRAD = 1e-6


def _nuclei(rng, size=96, n=9):
    """Dark disks and ellipses on a bright, slightly noisy background."""
    img = np.full((size, size, 3), 0.85, np.float32)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    for _ in range(n):
        cy, cx = rng.uniform(8, size - 8, 2)
        a, b, th = rng.uniform(3, 8), rng.uniform(3, 6), rng.uniform(0, np.pi)
        u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
        img[(u / a) ** 2 + (v / b) ** 2 <= 1] = rng.uniform(0.2, 0.35)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def test_watershed_and_masks_to_flows_bit_equal():
    rng = np.random.default_rng(0)
    from test_proposer_quality import make_case

    images = [_nuclei(rng) for _ in range(3)] + [make_case(rng)[0] for _ in range(2)]
    images.append(np.ones((32, 32, 3), np.float32))  # empty
    for kw in ({}, {"threshold": 0.5, "min_distance": 3, "min_size": 5}):
        for img in images:
            ref = jinst.DistanceWatershedProposer(**kw).propose(img)
            got = tinst.DistanceWatershedProposer(**kw).propose(img)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    for img in images[3:5]:
        inst = jinst.DistanceWatershedProposer().propose(img)
        np.testing.assert_array_equal(tinst.masks_to_flows(inst), jinst.masks_to_flows(inst))


def _jax_flownet(domain, **kw):
    """What ``FlowNetProposer.load_pretrained(domain)`` of the JAX package
    builds, without its throwaway eager ``net.init`` (the npz holds every
    parameter)."""
    with np.load(os.path.join(ARTIFACTS, f"flownet_{domain}.npz")) as z:
        features = tuple(int(f) for f in z["__features__"])
        params = unflatten_tree({k: z[k] for k in z.files if k != "__features__"})
    cfg = JDynUNetConfig(in_channels=3, num_classes=3, features_per_stage=features,
                         strides=(1,) + (2,) * (len(features) - 1), deep_supervision=False)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jinst.FlowNetProposer(params=params, net=JDynUNet(cfg), **kw)


@pytest.fixture(scope="module")
def synthetic():
    """The committed synthetic-domain artifact in both packages, and
    in-domain images."""
    from test_proposer_quality import make_case

    rng = np.random.default_rng(3)
    return {"jax": _jax_flownet("synthetic", n_iter=200),
            "port": tinst.FlowNetProposer.load_pretrained("synthetic", n_iter=200,
                                                          device="cpu"),
            "cases": [make_case(rng) for _ in range(3)]}


@pytest.mark.parametrize("domain,features", [("synthetic", (16, 32, 64)),
                                             ("transformed", (32, 64, 128))])
def test_flownet_artifacts_load_and_predict(domain, features, synthetic):
    with np.load(os.path.join(ARTIFACTS, f"flownet_{domain}.npz")) as z:
        assert tuple(z["__features__"]) == features and len(z.files) == 47
    jp = _jax_flownet(domain)
    tp = tinst.FlowNetProposer.load_pretrained(domain, device="cpu")
    assert tp.net.config.features_per_stage == features
    for img, _ in synthetic["cases"]:
        ref, got = jp.predict_flows(img), tp.predict_flows(img)
        assert got.shape == ref.shape == img.shape
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= FLOW_TOL, err


@pytest.mark.parametrize("method,n_iter", [("euler", 200), ("squaring", 200),
                                           ("squaring", 150), ("euler", 6)])
def test_follow_flows_matches_jax(method, n_iter, synthetic):
    img = synthetic["cases"][0][0]
    out = synthetic["jax"].predict_flows(img)
    flows, prob = out[..., :2] / 5.0, np.array(jax.nn.sigmoid(out[..., 2]))
    ref = np.asarray(jinst.follow_flows(jnp.asarray(flows), jnp.asarray(prob), n_iter=n_iter,
                                        method=method))
    got = tinst.follow_flows(torch.from_numpy(flows), torch.from_numpy(prob), n_iter=n_iter,
                             method=method).numpy()
    err = float(np.abs(got - ref).max())
    assert err <= POS_TOL, err
    np.testing.assert_array_equal(
        tinst.cluster_endpoints(got, prob), jinst.cluster_endpoints(got, prob))


def test_propose_matches_jax(synthetic):
    jp, tp = synthetic["jax"], synthetic["port"]
    for img, gt in synthetic["cases"]:
        j_sink, j_fg = (np.asarray(a) for a in jp._device_propose(img))
        t_sink, t_fg = (a.numpy() for a in tp._device_propose(img))
        assert t_sink.dtype == np.int32 and t_fg.dtype == bool
        np.testing.assert_array_equal(t_fg, j_fg)
        agree = float(np.mean(t_sink[j_fg] == j_sink[j_fg]))
        assert agree >= SINK_AGREEMENT, agree
        ours, ref = tp.propose(img), jp.propose(img)
        assert ref.max() > 0
        pq = teval.panoptic_quality(ours, ref)["pq"]
        assert pq >= PQ_AGREEMENT, pq


def test_proposer_reads_its_settings_at_every_call(synthetic):
    """Changing ``n_iter`` or ``prob_threshold`` after a first ``propose``
    takes effect (the JAX package's cached program keeps the first values),
    and the int32 flat sink index refuses an image of 2^31 pixels."""
    img = synthetic["cases"][1][0]
    prop = tinst.FlowNetProposer.load_pretrained("synthetic", n_iter=200, device="cpu")
    prop.propose(img)
    for change in ({"n_iter": 3}, {"prob_threshold": 0.95}):
        for k, v in change.items():
            setattr(prop, k, v)
        fresh = tinst.FlowNetProposer(net=prop.net, n_iter=prop.n_iter,
                                      prob_threshold=prop.prob_threshold)
        for a, b in zip(prop._device_propose(img), fresh._device_propose(img)):
            assert torch.equal(a, b)
    assert not torch.equal(prop._device_propose(img)[1], synthetic["port"]._device_propose(img)[1])
    huge = np.broadcast_to(np.zeros((), np.float32), (1 << 16, 1 << 15, 3))
    with pytest.raises(ValueError, match="int32"):
        prop._device_propose(huge)


def test_flownet_trainer_step_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    from test_proposer_quality import make_case

    cases = [make_case(rng, size=32) for _ in range(2)]
    images = np.stack([c[0] for c in cases]).astype(np.float32)
    targets = np.stack([jinst.masks_to_flows(c[1]) for c in cases])
    # the same weights in both packages, written by the JAX package's save
    seeded = tinst.FlowNetProposer.create(features=(8, 16), device="cpu")
    cfg = seeded.net.config
    jnet = JDynUNet(JDynUNetConfig(in_channels=3, num_classes=3, features_per_stage=(8, 16),
                                   strides=(1, 2), deep_supervision=False))
    params = jax.tree_util.tree_map(jnp.asarray, dynunet_to_flax(seeded.net.state_dict(), cfg))
    jprop = jinst.FlowNetProposer(params=params, net=jnet)
    path = str(tmp_path / "fn.npz")
    jprop.save(path)
    tprop = tinst.FlowNetProposer.load(path, device="cpu")
    jtr, ttr = jinst.FlowNetTrainer(jprop, lr=1e-3), tinst.FlowNetTrainer(tprop)

    @jax.jit
    def jax_step(params, opt_state, x, y):
        """The JAX trainer's step (``FlowNetTrainer._make_step``), returning
        its gradients too."""
        loss, grads = jax.value_and_grad(jprop.loss_fn)(params, x, y)
        updates, _ = jtr.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, loss

    jparams, grads, jloss = jax_step(jprop.params, jtr.opt_state, jnp.asarray(images),
                                     jnp.asarray(targets))
    before = {k: v.clone() for k, v in tprop.net.state_dict().items()}
    loss = ttr.step(torch.from_numpy(images), torch.from_numpy(targets))
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jgrad = dynunet_from_flax(jax.tree_util.tree_map(np.asarray, grads), cfg)
    got = dict(tprop.net.named_parameters())
    for k, ref in want.items():
        if k.endswith(".conv.bias"):  # in front of an InstanceNorm: exact gradient 0
            assert float(got[k].grad.abs().max()) <= NOISE_GRAD, k
            assert float(jgrad[k].abs().max()) <= NOISE_GRAD, k
            assert float((got[k].detach() - before[k]).abs().max()) <= 1e-3, k
            continue
        err = float((got[k].detach() - ref).abs().max() / ref.abs().max())
        assert err <= PARAM_TOL, (k, err)
    # save writes the JAX package's npz: the same keys, shapes and feature list
    tprop.save(str(tmp_path / "back.npz"))
    with np.load(path) as a, np.load(str(tmp_path / "back.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        back = unflatten_tree({k: b[k] for k in b.files if k != "__features__"})
    for k, v in dynunet_from_flax(back, cfg).items():
        assert torch.equal(v, tprop.net.state_dict()[k]), k


def test_flownet_trainer_train_runs():
    rng = np.random.default_rng(6)
    from test_proposer_quality import make_case

    cases = [make_case(rng, size=32) for _ in range(3)]
    prop = tinst.FlowNetProposer.create(features=(8, 16), device="cpu")
    losses = tinst.FlowNetTrainer(prop).train([c[0] for c in cases], [c[1] for c in cases],
                                              epochs=3, batch_size=2)
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.fixture(scope="module")
def transformed_scenes():
    """The held-out and crowded scenes of ``tests/test_proposer_quality.py``
    (same generators and seeds), transformed by the JAX tool as that test
    transforms them, in one call (one compile). The tool's
    ``SDComponents.random(image_size=64)`` is built by
    ``jax_random_components`` (the same configs, keys and initialisers, each
    init jitted)."""
    from ablate_flownet_transformed import make_crowded_case
    from torch_port_common import jax_random_components
    from train_flownet_artifact import make_case
    from train_flownet_transformed import transform_images

    rng = np.random.default_rng(42)
    held_out = [make_case(rng) for _ in range(4)]
    rng = np.random.default_rng(1234)
    crowded = [make_crowded_case(rng) for _ in range(6)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.SDComponents, "random",
                   classmethod(lambda cls, **kw: jax_random_components()))
        imgs = transform_images([im for im, _ in held_out + crowded])
    return {"held_out": (imgs[:4], [m for _, m in held_out]),
            "crowded": (imgs[4:], [m for _, m in crowded])}


@pytest.mark.parametrize("scene", ["held_out", "crowded"])
def test_transformed_artifact_meets_the_pq_pins(scene, transformed_scenes):
    """``tests/test_proposer_quality.py``'s pins on the committed
    ``flownet_transformed.npz``, for the port's proposer: PQ > 0.4 and >
    watershed + 0.2; and within 0.02 of the JAX proposer's PQ."""
    imgs, gts = transformed_scenes[scene]
    ws = teval.evaluate_instances([tinst.DistanceWatershedProposer().propose(im)
                                   for im in imgs], gts)
    tprop = tinst.FlowNetProposer.load_pretrained("transformed", n_iter=150, device="cpu")
    ours = teval.evaluate_instances([tprop.propose(im) for im in imgs], gts)
    jprop = _jax_flownet("transformed", n_iter=150)
    ref = jeval.evaluate_instances([jprop.propose(im) for im in imgs], gts)
    assert ours["pq"] > ws["pq"] + 0.2, (ours["pq"], ws["pq"])
    assert ours["pq"] > 0.4, ours["pq"]
    assert abs(ours["pq"] - ref["pq"]) <= 0.02, (ours["pq"], ref["pq"])


def _hand_cases():
    """The hand cases of ``tests/test_instance_metrics.py``."""
    gt = np.zeros((8, 8), np.int32)
    gt[:, :4], gt[:, 4:] = 1, 2
    pred = np.zeros((8, 8), np.int32)
    pred[:, :3], pred[:, 4:6] = 1, 2
    z = np.zeros((4, 4), np.int32)
    one = z.copy()
    one[1:3, 1:3] = 1
    sparse_gt = np.zeros((8, 8), np.int32)
    sparse_gt[:4, :4], sparse_gt[4:, 4:] = 7, 1000
    sparse_pred = np.zeros((8, 8), np.int32)
    sparse_pred[:4, :4], sparse_pred[4:, 4:] = 3, 12
    return [(gt, gt), (z, z), (one, z), (z, one), (pred, gt), (sparse_pred, sparse_gt)]


def test_instance_metrics_equal_jax():
    cases = _hand_cases()
    rng = np.random.default_rng(9)
    for _ in range(3):
        a = jinst.DistanceWatershedProposer().propose(_nuclei(rng))
        b = jinst.DistanceWatershedProposer(min_distance=3).propose(_nuclei(rng))
        cases.append((a, b))
    for pred, gt in cases:
        assert teval.panoptic_quality(pred, gt) == jeval.panoptic_quality(pred, gt)
        assert teval.aggregated_jaccard_index(pred, gt) == \
            jeval.aggregated_jaccard_index(pred, gt)
    preds, gts = zip(*cases)
    assert teval.evaluate_instances(preds, gts) == jeval.evaluate_instances(preds, gts)
    assert teval.panoptic_quality(*cases[4])["pq"] == pytest.approx(0.375)
    assert teval.aggregated_jaccard_index(*cases[4]) == pytest.approx(0.625)


def test_folder_report_equals_jax(tmp_path):
    """``evaluate``'s report at the cell level (11 classes, PUMA pixel codes in
    the ground truth; one prediction at another size)."""
    rng = np.random.default_rng(10)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(3):
        gt = (rng.integers(0, 11, (16, 16)) * 25).astype(np.uint8)
        size = (16, 16) if i else (24, 20)
        pred = rng.integers(0, 11, size).astype(np.uint8)
        Image.fromarray(gt).save(gt_dir / f"c{i}.png")
        Image.fromarray(pred).save(pred_dir / f"c{i}.png")
    ours = teval.evaluate(str(pred_dir), str(gt_dir), 11, "cell",
                          output_dir=str(tmp_path / "ours"))
    ref = jeval.evaluate(str(pred_dir), str(gt_dir), 11, "cell",
                         output_dir=str(tmp_path / "ref"))
    assert ours["mean"] == ref["mean"] and ours["num_images"] == ref["num_images"] == 3
    for key in ("dice_per_class", "iou_per_class"):
        np.testing.assert_array_equal(ours["pooled"][key], ref["pooled"][key])
    with open(ours["report_path"]) as f, open(ref["report_path"]) as g:
        assert f.read().replace(str(tmp_path / "ours"), "") == \
            g.read().replace(str(tmp_path / "ref"), "")
    teval.main(["--pred-dir", str(pred_dir), "--gt-dir", str(gt_dir), "--num-classes", "11",
                "--level", "cell", "--output-dir", str(tmp_path / "cli")])
    assert os.listdir(tmp_path / "cli")
