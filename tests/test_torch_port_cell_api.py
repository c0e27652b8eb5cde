"""The cell slice as a whole: ``LDiffusionModel(..., "cell").train(component=
"segmentor"|"all")`` and ``inference`` of the port on the CPU, at the tiny SD
components and synthetic 64² PUMA-like PNGs (dark nuclei, 11-class cell
labels), then the JAX package's ``CellSegClassifier`` on the port's
checkpoint and the same encoder (the port's seeded ResNet-152, carried over
with ``resnet_to_flax``: the checkpoint holds only the head).

Tolerance: the JAX and port masks agree on ≥ 99.5% of pixels for the same
transformed image (the watershed instances are the same numpy code on the
same f32 image; a class may flip only where two logits of the f32 ResNet-152
tie to rounding).

The ResNet-152 runs here on the CPU; its convolutions take a few threads
(``torch.set_num_threads``), so that several test workers on one host do not
oversubscribe its cores.
"""
import argparse
import os
import time
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from ldiffusion_tpu.cell.classifier import CellSegClassifier as JClassifier
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
from ldiffusion_tpu_torch.data.dataset import load_image
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_text_emb
from ldiffusion_tpu_torch.models.convert import resnet_to_flax, save_unet_dir
from ldiffusion_tpu_torch.models.resnet import ResNetConfig

MASK_AGREEMENT = 0.995
CELL_CODES = np.arange(11, dtype=np.uint8) * 25  # PUMA cell pixel values of classes 0..10


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _pairs(root, rng, n):
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    for i in range(n):
        img, lab = _nuclei_pair(rng, 64, 64)
        img.save(images / f"roi_{i}.png")
        lab.save(labels / f"roi_{i}.png")
    # num_epochs 11 → max(1, 11 - 10) = 1 cell epoch
    return argparse.Namespace(image_dir=str(images), label_dir=str(labels), num_epochs=11,
                              batch_size=1, num_inference_steps=5, num_classes=11)


def _nuclei_pair(rng, h, w):
    """A pink ROI with dark nuclei, and its cell label PNG."""
    img = np.empty((h, w, 3), np.float32)
    img[:] = (0.92, 0.75, 0.85)
    img += rng.normal(0, 0.02, img.shape)
    lab = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(rng.integers(6, 10)):
        cy, cx, r = rng.uniform(5, h - 5), rng.uniform(5, w - 5), rng.uniform(3, 6)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[m] = (0.3, 0.15, 0.4) + rng.normal(0, 0.02, 3)
        lab[m] = CELL_CODES[rng.integers(1, 11)]
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)), Image.fromarray(lab)


@pytest.fixture(scope="module")
def cell_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cell_slice")
    rng = np.random.default_rng(11)
    args = _pairs(root, rng, 5)  # 70/30: 3 training ROIs, 2 validation ROIs
    wide = root / "wide.png"
    _nuclei_pair(rng, 48, 80)[0].save(wide)
    comps = SDComponents.random(seed=5, device="cpu")
    unet_dir = str(root / "unet")
    save_unet_dir(unet_dir, comps.unet_config, comps.unet.state_dict(), comps.proj.state_dict())
    return {"root": root, "args": args, "comps": comps, "unet_dir": unet_dir,
            "square": os.path.join(args.image_dir, "roi_0.png"), "wide": str(wide)}


def test_cell_train_and_inference_match_jax(cell_world):
    root, args = cell_world["root"], cell_world["args"]
    model = LDiffusionModel("random:tiny", "cell", components=cell_world["comps"], device="cpu",
                            work_dir=str(root / "work"))
    ckpt = model.train(args, component="segmentor",
                       ldiffusion_weight=cell_world["unet_dir"])["segmentor"]
    assert ckpt == os.path.join(str(root / "work"), "cellclassifier", time.strftime("%y_%m_%d"),
                                "cellclassifier.pkl")
    assert os.path.exists(ckpt)
    tr = model.cell_trainer
    assert len(tr.epoch_seconds) == 1  # max(1, 11 - 10) epochs
    assert tr.model.encoder_cfg == ResNetConfig.resnet152()

    # the JAX classifier on the port's checkpoint, with the port's encoder
    # (every CellSegClassifier draws the same one)
    jmodel = JClassifier(11, encoder_variables=resnet_to_flax(tr.model.encoder.state_dict(),
                                                              ResNetConfig.resnet152()))
    jmodel.load(ckpt)
    comps = model._components
    found = 0
    for path in (cell_world["square"], cell_world["wide"]):
        decoded, mask = model.inference(path, cell_world["unet_dir"], os.path.dirname(ckpt), 11)
        with Image.open(path) as f:
            w, h = f.size
        assert decoded.size == (w, h) and mask.shape == (h, w) and mask.dtype == np.uint8
        assert int(mask.max()) < 11
        found += model.cell_seconds["instances"]
        with torch.inference_mode():
            t = model._transform(load_image(path, (64, 64)), trajectory_text_emb(comps, 1))
        t = t.float().numpy()
        ref = np.asarray(Image.fromarray(jmodel.predict_mask(t)).resize((w, h), Image.NEAREST))
        agree = float(np.mean(ref == mask))
        assert agree >= MASK_AGREEMENT, (path, agree)
    assert found > 0  # the transformed ROIs hold instances to classify


def test_cell_train_all_components(tmp_path):
    """``component="all"``: stage 1, then the cell head on the UNet it saved
    (3 ROI pairs: 2 for training, 1 for validation)."""
    args = _pairs(tmp_path, np.random.default_rng(12), 3)
    model = LDiffusionModel(
        "random:tiny", "cell", components=SDComponents.random(seed=6, device="cpu"),
        device="cpu", work_dir=str(tmp_path),
        diffusion_config=DiffusionTrainConfig(num_epochs=1, num_inference_steps=5,
                                              num_classes=11, compute_dtype="float32"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        out = model.train(args, component="all")
    assert set(out) == {"ldiffusion", "segmentor"}
    assert os.path.exists(os.path.join(out["ldiffusion"], "unet_params.npz"))
    assert os.path.exists(out["segmentor"])
    with pytest.raises(ValueError, match="Invalid level"):
        LDiffusionModel("random:tiny", "organ", device="cpu").train(args)
