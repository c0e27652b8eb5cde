"""The port's ResNet encoder, device crop-and-resize, instance classifier,
``CellTrainer`` and ``micro_dice`` against the JAX package's
(``ldiffusion_tpu/models/resnet.py``, ``cell/classifier.py``,
``losses/dice.py``), on the same weights (the JAX encoder's variables through
``resnet_from_flax``; the head through the flax layout) and numpy inputs.

Tolerances: the encoders' features ≤ 1e-4 of their largest value (f32 conv
stacks in another summation order, 1-16 bottlenecks deep at 64²);
``roi_resize_64`` ≤ 1e-5 (the same gather and blend, rounding only); the
classes, painted masks and checkpoint contents equal; one ``CellTrainer``
step's loss to 1e-6 relative and its head ≤ 1e-5 of each tensor's largest
value; ``micro_dice`` per class equal, its mean (an f32 mean of 11 values in
another order) to one ulp.

AdamW divides each gradient element by its own magnitude (plus eps 1e-8), so
an element whose gradient is within rounding of 0 (the two packages' head
gradients differ by up to 7e-9 absolute) steps by an arbitrary amount up to
lr. The head is therefore held to 1e-5 where the JAX gradient is at least
1e-6 in magnitude, and elsewhere to the bound of two AdamW trajectories,
2·lr a step; over several steps, to 1e-5 on all but 0.1% (at least one) of
each tensor's elements and that bound on all.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.cell import classifier as jcls
from ldiffusion_tpu.losses.dice import micro_dice as jmicro_dice
from ldiffusion_tpu.models.resnet import ResNetConfig as JResNetConfig
from ldiffusion_tpu.models.resnet import ResNetEncoder as JResNetEncoder
from ldiffusion_tpu_torch.cell import classifier as tcls
from ldiffusion_tpu_torch.losses.dice import micro_dice
from ldiffusion_tpu_torch.models.convert import (
    CELL_HEAD_ROWS,
    from_flax,
    resnet_from_flax,
    resnet_rows,
    resnet_to_flax,
    to_flax,
)
from ldiffusion_tpu_torch.models.resnet import ResNetConfig, ResNetEncoder
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

FEATURE_TOL = 1e-4
RESIZE_TOL = 1e-5
LOSS_RTOL = 1e-6
HEAD_TOL = 1e-5
LR = 1e-4
SETTLED_GRAD = 1e-6


def _random_stats(variables, rng):
    """BatchNorm away from identity: scale, bias, mean and variance drawn, so
    every leaf of the mapping matters."""
    out = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, v in params.items():
            if "scale" in v:
                c = v["scale"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(v, dict) and k in stats:
                walk(v, stats[k])

    walk(out["params"], out["batch_stats"])
    return out


def _jax_encoder(cfg_name, seed):
    cfg = getattr(JResNetConfig, cfg_name)()
    enc = JResNetEncoder(cfg)
    variables = jax.jit(enc.init)(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)))
    return enc, _random_stats(variables, np.random.default_rng(seed))


@pytest.mark.parametrize("cfg_name", ["tiny", "resnet50"])
def test_resnet_matches_jax(cfg_name):
    enc, variables = _jax_encoder(cfg_name, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: enc.apply(v, x, train=False))(variables, x))
    cfg = getattr(ResNetConfig, cfg_name)()
    port = ResNetEncoder(cfg)
    port.load_state_dict(resnet_from_flax(variables, cfg))  # strict: every key mapped
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    side = 64 // (4 * 2 ** (len(cfg.stage_sizes) - 1))
    assert got.shape == ref.shape == (2, side, side, cfg.out_channels)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= FEATURE_TOL, err
    back = resnet_to_flax(port.state_dict(), cfg)
    for (ka, a), (kb, b) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(back)[0], key=lambda kv: str(kv[0])),
            sorted(jax.tree_util.tree_flatten_with_path(variables)[0],
                   key=lambda kv: str(kv[0]))):
        assert str(ka) == str(kb)
        np.testing.assert_array_equal(a, b)


def test_resnet152_at_full_width_on_meta():
    """torchvision's ResNet-152 trunk: 60,192,808 parameters less the
    2,049,000 of its ``fc``; (B, 2048, H/32, W/32)."""
    with torch.device("meta"):
        enc = ResNetEncoder(ResNetConfig.resnet152())
        out = enc(torch.empty(3, 3, 64, 96))
    assert sum(p.numel() for p in enc.parameters()) == 60_192_808 - 2_049_000
    assert tuple(out.shape) == (3, 2048, 2, 3)
    names = set(enc.state_dict())
    assert {"conv1.weight", "bn1.running_var", "layer3.35.conv3.weight",
            "layer4.0.downsample.0.weight", "layer4.0.downsample.1.num_batches_tracked"} <= names
    mapped = set()
    for tp, _, kind in resnet_rows(ResNetConfig.resnet152()):
        mapped.add(f"{tp}.weight")
        if kind == "norm":
            mapped.update(f"{tp}.{k}" for k in ("bias", "running_mean", "running_var",
                                                  "num_batches_tracked"))
    assert mapped == names


def _instances(rng, h=96, w=96, n=14):
    """Blob instances, some under MIN_BOX and an id gap."""
    inst = np.zeros((h, w), np.int32)
    next_id = 1
    for k in range(n):
        cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
        r = int(rng.integers(1, 10))
        yy, xx = np.ogrid[:h, :w]
        inst[((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (inst == 0)] = next_id
        next_id += 4 if k == 4 else 1
    return inst


def test_boxes_patches_and_roi_resize_match_jax():
    rng = np.random.default_rng(3)
    image = rng.random((96, 96, 3)).astype(np.float32)
    inst = _instances(rng)
    assert tcls.extract_instance_boxes(inst) == jcls.extract_instance_boxes(inst)
    got, ref = tcls.extract_instance_patches(image, inst), jcls.extract_instance_patches(image, inst)
    assert got[1:] == ref[1:]
    np.testing.assert_array_equal(got[0], ref[0])
    empty = np.zeros((32, 32), np.int32)
    assert tcls.extract_instance_boxes(empty) == ([], [])
    assert tcls.extract_instance_patches(image, empty)[0].shape == (0, 64, 64, 3)
    boxes = [(0, 0, 95, 95), (3, 7, 9, 12), (90, 80, 95, 95), (10, 20, 90, 30)]
    for _ in range(12):
        x1, y1 = rng.integers(0, 80, 2)
        boxes.append((int(x1), int(y1), int(min(x1 + rng.integers(4, 70), 95)),
                      int(min(y1 + rng.integers(4, 70), 95))))
    bb = np.asarray(boxes, np.float32)
    ref = np.asarray(jcls.roi_resize_64(jnp.asarray(image), jnp.asarray(bb)))
    got = tcls.roi_resize_64(torch.from_numpy(image), torch.from_numpy(bb)).numpy()
    assert got.shape == ref.shape == (len(boxes), 64, 64, 3)
    err = float(np.abs(got - ref).max())
    assert err <= RESIZE_TOL, err


class _Fixed:
    def __init__(self, inst):
        self.inst = inst

    def propose(self, image):
        return self.inst


def _pair(num_classes=5, seed=1):
    """A JAX classifier and the port's with its encoder and head."""
    cfg = JResNetConfig.tiny()
    jc = jcls.CellSegClassifier(num_classes, encoder_cfg=cfg, rng=jax.random.key(seed))
    jc.encoder_vars = _random_stats(jc.encoder_vars, np.random.default_rng(seed))
    tc = tcls.CellSegClassifier(num_classes, encoder_cfg=ResNetConfig.tiny(), device="cpu")
    tc.encoder.load_state_dict(resnet_from_flax(jc.encoder_vars, ResNetConfig.tiny()))
    tc.head.load_state_dict(from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray,
                                                                              jc.head)))
    return jc, tc


def test_classify_and_predict_mask_match_jax():
    rng = np.random.default_rng(4)
    image = rng.random((96, 96, 3)).astype(np.float32)
    inst = _instances(rng)
    jc, tc = _pair()
    jc.proposer = tc.proposer = _Fixed(inst)
    ids, boxes = tcls.extract_instance_boxes(inst)
    patches = tcls.extract_instance_patches(image, inst)[0]
    assert len(ids) >= 8
    np.testing.assert_array_equal(tc.classify_patches(patches), jc.classify_patches(patches))
    np.testing.assert_array_equal(tc.classify_rois(image, boxes), jc.classify_rois(image, boxes))
    np.testing.assert_array_equal(tc.classify_rois(image, boxes)[:3],
                                  tc.classify_rois(image, boxes[:3]))  # pad rows inert
    np.testing.assert_array_equal(tc.forward(image)["out"], jc.forward(image)["out"])
    mask = tc.predict_mask(image)
    np.testing.assert_array_equal(mask, jc.predict_mask(image))
    np.testing.assert_array_equal(mask, tc.forward(image)["out"][0].argmax(-1))
    assert tc.last_predict["instances"] == len(ids) and tc.last_predict["bucket"] == 32
    assert tc._bucket(513) == 1024 and tc._bucket(300) == 512 and tc._bucket(1100) == 1536
    # the watershed proposer (the default) on dark nuclei
    nuclei = np.full((96, 96, 3), 0.85, np.float32)
    nuclei[inst > 0] = 0.25
    jc.proposer, tc.proposer = jcls.DistanceWatershedProposer(), tcls.DistanceWatershedProposer()
    np.testing.assert_array_equal(tc.predict_mask(nuclei), jc.predict_mask(nuclei))


def test_cell_trainer_step_matches_jax():
    rng = np.random.default_rng(5)
    jc, tc = _pair(num_classes=6, seed=2)
    jtr, ttr = jcls.CellTrainer(jc), tcls.CellTrainer(tc)
    feats = rng.normal(size=(32, 2, 2, 64)).astype(np.float32)
    labels = rng.integers(0, 6, 32).astype(np.int32)
    valid = (np.arange(32) < 21).astype(np.float32)
    jhead, _, jloss = jtr._step(jc.head, jtr.opt_state, jnp.asarray(feats),
                                jnp.asarray(labels), jnp.asarray(valid))
    loss = ttr.step(torch.from_numpy(feats).permute(0, 3, 1, 2), torch.from_numpy(labels),
                    torch.from_numpy(valid))
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray, jhead))
    grads = {k: p.grad for k, p in tc.head.named_parameters()}
    for k, v in tc.head.state_dict().items():
        diff = (v - want[k]).abs()
        settled = grads[k].abs() >= SETTLED_GRAD
        assert settled.float().mean() > 0.999, k
        err = float(diff[settled].max() / want[k].abs().max())
        assert err <= HEAD_TOL, (k, err)
        assert float(diff.max()) <= 2 * LR, k


def test_cell_trainer_train_matches_jax(tmp_path):
    """Two epochs over the feature cache, validation by micro-Dice through
    ``predict_mask``, the best checkpoint under ``<save_dir>/<yy_mm_dd>/``."""
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(3):
        inst = _instances(rng, 64, 64, 8)
        img = np.full((64, 64, 3), 0.85, np.float32)
        img[inst > 0] = 0.2 + 0.1 * rng.random()
        gt = np.where(inst > 0, inst % 4 + 1, 0).astype(np.int32)
        pairs.append((img, gt))
    jc, tc = _pair(num_classes=5, seed=3)
    jpath = jcls.CellTrainer(jc).train(pairs[:2], pairs[2:], 2, save_dir=str(tmp_path / "j"))
    ttr = tcls.CellTrainer(tc)
    tpath = ttr.train(pairs[:2], pairs[2:], 2, save_dir=str(tmp_path / "t"))
    assert tpath.endswith("cellclassifier.pkl") and \
        tpath[len(str(tmp_path / "t")):] == jpath[len(str(tmp_path / "j")):]
    assert len(ttr.epoch_seconds) == 2 and ttr.feature_cache_seconds > 0
    want = from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray, jc.head))
    steps = 2 * 2  # 2 epochs x 2 cached training images
    for k, v in tc.head.state_dict().items():
        diff = (v - want[k]).abs()
        off = int((diff > HEAD_TOL * want[k].abs().max()).sum())
        assert off <= max(1, diff.numel() // 1000), (k, off)
        assert float(diff.max()) <= 2 * LR * steps, k
    np.testing.assert_array_equal(tc.predict_mask(pairs[2][0]), jc.predict_mask(pairs[2][0]))


def test_instance_majority_labels_equal():
    rng = np.random.default_rng(7)
    inst = _instances(rng)
    gt = rng.integers(0, 11, inst.shape).astype(np.int64)
    ids = [int(i) for i in np.unique(inst) if i]
    np.testing.assert_array_equal(tcls.CellTrainer.instance_majority_labels(inst, gt, ids),
                                  jcls.CellTrainer.instance_majority_labels(inst, gt, ids))


def test_micro_dice_equal():
    rng = np.random.default_rng(8)
    pred = rng.integers(0, 11, (2, 16, 16))
    true = rng.integers(0, 9, (2, 16, 16))  # classes 9 and 10 absent: empty → 1 where unpredicted
    pred[pred == 10] = 0
    for p, t in ((pred, true), (true, true), (np.zeros_like(true), np.zeros_like(true))):
        got = micro_dice(torch.from_numpy(p), torch.from_numpy(t), 11)
        ref = jmicro_dice(jnp.asarray(p), jnp.asarray(t), 11)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert float(got[1]) == pytest.approx(float(ref[1]), rel=2 ** -23)
    logits = rng.normal(size=(2, 16, 16, 11)).astype(np.float32)
    got = micro_dice(torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(true), 11)
    ref = jmicro_dice(jnp.asarray(logits), jnp.asarray(true), 11)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_checkpoints_cross_read(tmp_path):
    jc, tc = _pair(num_classes=4, seed=4)
    with torch.no_grad():
        for p in tc.head.parameters():
            p.add_(0.01)
    tc.save(str(tmp_path / "port.pkl"))
    jc.load(str(tmp_path / "port.pkl"))
    want = to_flax(CELL_HEAD_ROWS, tc.head.state_dict())
    for (ka, a), (kb, b) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(jc.head)[0], key=lambda kv: str(kv[0])),
            sorted(jax.tree_util.tree_flatten_with_path(want)[0], key=lambda kv: str(kv[0]))):
        assert str(ka) == str(kb)
        np.testing.assert_array_equal(np.asarray(a), b)
    jc.head = jax.tree_util.tree_map(lambda x: x * 2, jc.head)
    jc.save(str(tmp_path / "jax.pkl"))
    tc.load(str(tmp_path / "jax.pkl"))
    for k, v in from_flax(CELL_HEAD_ROWS, jax.tree_util.tree_map(np.asarray, jc.head)).items():
        assert torch.equal(tc.head.state_dict()[k], v), k
    with pytest.raises(ValueError, match="4-class"):
        tcls.CellSegClassifier(5, encoder_cfg=ResNetConfig.tiny(), device="cpu").load(
            str(tmp_path / "jax.pkl"))
