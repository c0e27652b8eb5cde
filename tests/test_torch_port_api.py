"""The whole ported slice — ``LDiffusionModel.inference_tissue`` — against the
JAX package's, on the artifacts the JAX package writes.

The JAX side writes a tiny segmentor directory (``plans.json``, a
``save_pytree`` checkpoint holding params and an optax ``opt_state``,
``postprocessing.json``); both packages then run tissue inference on the same
SD weights over synthetic PNGs, single-image and folder mode, with one
non-square image. Masks must agree on ≥ 99.5% of pixels, with both DynUNets
in f32: the JAX predictor's default bf16 agrees with its own f32 masks on only
98.8-99.5% of these random-weight masks (2-4% of pixels have their top two
logits within 0.01), so against bf16 the bar would measure bf16 noise, not
the port. In f32 a pixel flips only where the two transformed images' 1e-3
difference decides a near-tie. The transformed images are uint8 PNG values of
[0, 1] floats that agree to 1e-3 (``test_torch_port_pipeline``), so they may
differ by one level where a value sits at a rounding edge.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from ldiffusion_tpu.api import LDiffusionModel as JModel
from ldiffusion_tpu.core.checkpoint import save_pytree
from ldiffusion_tpu.models.convert import save_unet_dir
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.segmentor.planner import SegPlan as JSegPlan
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.cell import CellSegClassifier, FlowNetProposer
from ldiffusion_tpu_torch.core.checkpoint import Inert, load_pytree
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
from ldiffusion_tpu_torch.models.convert import load_unet_dir, proj_from_flax, unet_from_flax
from ldiffusion_tpu_torch.models.resnet import ResNetConfig
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor
from torch_port_common import jax_random_components
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

MASK_AGREEMENT = 0.995
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SQUARE = ("roi_0.png", "roi_1.png", "roi_2.png")
NON_SQUARE = "roi_3_wide.png"


def _tissue_like(rng, h, w):
    """A smooth synthetic ROI: a coarse random field upsampled, plus faint
    noise (pure per-pixel noise would make every pixel a near-tie)."""
    coarse = Image.fromarray((rng.random((h // 8, w // 8, 3)) * 255).astype(np.uint8))
    field = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.float32)
    field += rng.normal(scale=8.0, size=field.shape)
    return Image.fromarray(np.clip(field, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w) in zip(SQUARE + (NON_SQUARE,), [(64, 64)] * 3 + [(40, 56)]):
        _tissue_like(rng, h, w).save(images / name)

    plan = JSegPlan(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16, 32),
                    strides=(1, 2, 2), n_conv_per_stage=2, num_classes=7, in_channels=3,
                    normalization="zscore_image", intensity_properties={},
                    median_shape=(64, 64), batch_dice=True)
    seg = root / "segmentor"
    plan.save(str(seg / "plans.json"))
    params = jax.jit(JDynUNet(plan.network_config()).init)(
        jax.random.key(5), jnp.zeros((1, 32, 32, 3)))["params"]
    opt_state = optax.sgd(1e-2, momentum=0.99, nesterov=True).init(params)
    save_pytree(str(seg / "fold_0" / "checkpoint_final.pkl"),
                {"params": params, "opt_state": opt_state, "step": jnp.int32(7),
                 "batch_stats": {}, "epoch": 1, "best_ema": 0.5, "logger": {},
                 "plan": plan.to_json()})
    with open(seg / "postprocessing.json", "w") as f:
        json.dump([{"fn": "remove_all_but_largest_component", "labels": [1]}], f)
    return {"root": root, "images": images, "seg": str(seg),
            "jax_components": jax_random_components()}


@pytest.fixture(scope="module")
def jax_masks(world):
    """JAX single-image inference on every image, its DynUNet in f32:
    name → (decoded, mask)."""
    model = JModel("random:tiny", "tissue", components=world["jax_components"],
                   work_dir=str(world["root"] / "jax_work"))
    load = JPredictor.from_checkpoints.__func__
    f32 = classmethod(lambda cls, plan, paths, **kw: load(cls, plan, paths,
                                                           dtype=jnp.float32, **kw))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPredictor, "from_checkpoints", f32)
        for name in SQUARE + (NON_SQUARE,):
            decoded, mask = model.inference_tissue(str(world["images"] / name), None,
                                                   world["seg"], 7)
            out[name] = (np.asarray(decoded), np.asarray(mask))
    return out


@pytest.fixture
def port_model(world, monkeypatch):
    """The port's model on the CPU, its DynUNet in f32 as on the JAX side."""
    load = TPredictor.from_checkpoints.__func__
    monkeypatch.setattr(TPredictor, "from_checkpoints", classmethod(
        lambda cls, plan, paths, **kw: load(cls, plan, paths, dtype=torch.float32, **kw)))
    comps = SDComponents.from_flax(world["jax_components"].params, device="cpu")
    return LDiffusionModel("random:tiny", "tissue", components=comps, device="cpu")


def _agreement(a, b):
    assert a.shape == b.shape
    return float(np.mean(a == b))


def test_checkpoint_reads_without_optax_classes(world):
    ck = load_pytree(os.path.join(world["seg"], "fold_0", "checkpoint_final.pkl"))
    assert isinstance(ck["params"]["enc_0_0"]["conv"]["kernel"], np.ndarray)
    assert any(isinstance(s, Inert) for s in jax.tree_util.tree_leaves(
        ck["opt_state"], is_leaf=lambda x: isinstance(x, Inert)))
    assert json.loads(ck["plan"])["num_classes"] == 7


def test_single_image_matches_jax(world, jax_masks, port_model):
    model = port_model
    for name in SQUARE + (NON_SQUARE,):
        decoded, mask = model.inference(str(world["images"] / name), None, world["seg"], 7)
        jdecoded, jmask = jax_masks[name]
        assert mask.dtype == np.uint8 and mask.max() < 7
        assert _agreement(mask, jmask) >= MASK_AGREEMENT, name
        diff = np.abs(np.asarray(decoded, np.int16) - jdecoded.astype(np.int16))
        assert diff.max() <= 1, name


def test_folder_mode_matches_jax_and_skips_existing(world, jax_masks, port_model):
    out_dir = world["root"] / "port_masks"
    model = port_model
    assert model.inference_tissue(str(world["images"]), None, world["seg"], 7,
                                  output_path=str(out_dir)) == (None, None)
    for name in SQUARE + (NON_SQUARE,):
        mask = np.asarray(Image.open(out_dir / name))
        assert _agreement(mask, jax_masks[name][1]) >= MASK_AGREEMENT, name
    sentinel = np.zeros((64, 64), np.uint8)
    Image.fromarray(sentinel).save(out_dir / SQUARE[0])
    model.inference_tissue(str(world["images"]), None, world["seg"], 7,
                           output_path=str(out_dir), overwrite=False)
    np.testing.assert_array_equal(np.asarray(Image.open(out_dir / SQUARE[0])), sentinel)


def test_reads_the_jax_unet_dir(world, tmp_path):
    jc = world["jax_components"]
    save_unet_dir(str(tmp_path / "unet"), jc.unet_config, jc.params["unet"],
                  proj=jc.params["proj"])
    config, unet_sd, proj_sd = load_unet_dir(str(tmp_path / "unet"))
    assert config.block_out_channels == jc.unet_config.block_out_channels
    want = unet_from_flax(jc.params["unet"], config)
    assert set(unet_sd) == set(want)
    for k in want:
        assert torch.equal(unet_sd[k], want[k]), k
    for k, v in proj_from_flax(jc.params["proj"]).items():
        assert torch.equal(proj_sd[k], v)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LDiffusionModel("random:tiny", "tissue")
    with pytest.raises(RuntimeError, match="CUDA"):
        SDComponents.random()
    with pytest.raises(RuntimeError, match="CUDA"):
        LDiffusionModel("random:tiny", "cell")
    with pytest.raises(RuntimeError, match="CUDA"):
        CellSegClassifier(3, encoder_cfg=ResNetConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        FlowNetProposer.create(features=(8, 16))
    model = LDiffusionModel("random:tiny", "cell", device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(FileNotFoundError):  # a diffusers directory is read, not refused
        LDiffusionModel("no/such/sd15", "cell", device="cpu")._load_components()


_HYGIENE = r"""
import importlib, pkgutil, sys
import ldiffusion_tpu_torch
from ldiffusion_tpu_torch.api import LDiffusionModel
model = LDiffusionModel("random:tiny", "tissue", device="cpu")
decoded, mask = model.inference(sys.argv[1], None, sys.argv[2], 7)
assert mask.shape == (64, 64), mask.shape
# the cell level's runtime paths: both proposers and the classifier
import numpy as np
from ldiffusion_tpu_torch.cell import CellSegClassifier, FlowNetProposer
from ldiffusion_tpu_torch.models.resnet import ResNetConfig
image = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
FlowNetProposer.load_pretrained("transformed", n_iter=20, device="cpu").propose(image)
CellSegClassifier(3, encoder_cfg=ResNetConfig.tiny(), device="cpu").predict_mask(image)
# the segmentor CLI's parser and a trainer variant with a label manager
from ldiffusion_tpu_torch.segmentor.cli import build_parser
from ldiffusion_tpu_torch.segmentor.label_manager import LabelManager
from ldiffusion_tpu_torch.segmentor.variants import get_variant
build_parser().parse_args(["train", "-d", "1", "-tr", "nnUNetTrainerDA5"])
assert get_variant("nnUNetTrainerAdan").optimizer == "adan"
assert LabelManager({"background": 0, "a": (1, 2)}, [1]).has_regions
# the workflow after training: a Laplace draw, a Canny map, a best configuration
import torch
from ldiffusion_tpu_torch.core.prng import fold_in_step, laplace
from ldiffusion_tpu_torch.data.rgbd import canny_edges
from ldiffusion_tpu_torch.segmentor.best_config import find_best_configuration
assert laplace(fold_in_step(0, 1, 2), (4,), 0.5).shape == (4,)
canny_edges(np.zeros((8, 8), np.uint8))
probs = [np.random.default_rng(0).random((8, 8, 2))]
assert find_best_configuration({"2d": probs}, [np.zeros((8, 8), int)], 2)["members"] == ["2d"]
# the int8 modes: a quantized forward of the tiny transform's layers
from ldiffusion_tpu_torch.ops.quant import set_quant_mode
set_quant_mode("int8_all")
with torch.no_grad():
    model._components.vae.encode_mean(torch.zeros(1, 3, 16, 16))
set_quant_mode("none")
# every module of the package, both training slices' included
names = [m.name for m in pkgutil.walk_packages(ldiffusion_tpu_torch.__path__,
                                               "ldiffusion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("train.ldiffusion", "segmentor.trainer", "segmentor.preprocess",
             "segmentor.fingerprint", "segmentor.splits", "segmentor.dataset_builder",
             "data.augment", "data.patches", "data.prefetch", "losses.dice", "native",
             "evaluate", "cell", "cell.instance", "cell.classifier", "models.resnet",
             "models.tokenizer", "models.safetensors_io", "core.paths", "core.registry",
             "core.optim", "data.io", "segmentor.label_manager", "segmentor.variants",
             "segmentor.pretrained", "segmentor.export", "segmentor.cli",
             "segmentor.__main__", "ldiffusion", "models.dynunet3d", "segmentor.resample",
             "segmentor.planner3d", "segmentor.plans_file", "segmentor.best_config",
             "segmentor.model_sharing", "segmentor.batch_running", "data.converters",
             "data.public_converters", "data.rgbd", "core.prng", "utils",
             "models.controlnet", "models.conductor", "diffusion.multimodal", "tools",
             "tools.sample", "tools.pixel_latent_vector", "ops.quant", "core.dist"):
    assert "ldiffusion_tpu_torch." + want in names, (want, names)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ldiffusion_tpu",
                                    "safetensors"))
print("FOREIGN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_nothing_of_jax(world):
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, str(world["images"] / SQUARE[0]),
                           world["seg"]], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout
