"""Public API (counterpart of ``ldiffusion_tpu/api.py``): stage-1 training
and tissue inference.

    model = LDiffusionModel(diffusion_path, level="tissue")      # on cuda
    weights = model.train(args, component="ldiffusion")          # {"ldiffusion": dir}
    decoded, mask = model.inference(image_path, weights["ldiffusion"],
                                    segmentor_weight, num_classes)

Training (``component="ldiffusion"``): a 70/30 split of the image/label
pairs, then ``DiffusionWarmupTrainer`` on 64² images and labels; the UNet is
saved in the JAX trainer's directory layout, which ``inference`` reads back.

Per ROI: CLIP text → projection, VAE ``encode_mean``, PNDM one step through
the UNet, ``decode_latents``, z-score, sliding-window DynUNet with gaussian
blending and 4-way mirror TTA → uint8 mask. The ROI is 1024² unless
``diffusion_path`` starts with ``random:`` (then 64²); non-square images skip
the diffusion transform; in folder mode existing outputs are skipped unless
``overwrite``.

Not ported yet (they raise ``NotImplementedError``): segmentor training
(``component="all"`` or ``"segmentor"``, ROADMAP queue 1 item 10), the cell
level (item 11), and reading a diffusers SD checkpoint directory (item 6) — a
non-``random:`` path needs ``components=``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.data.dataset import (
    SegmentationDataset,
    list_pairs,
    load_image,
    split_dataset,
)


class LDiffusionModel:
    def __init__(self, diffusion_path: str, level: str, local_rank: int = -1,
                 components=None, device=None, work_dir: str = "train_save",
                 diffusion_config: Optional[DiffusionTrainConfig] = None):
        """``device``: None → the GPU (raises when there is none); pass
        ``"cpu"`` to run on the CPU. ``components``: an ``SDComponents``
        bundle, moved to ``device``. ``diffusion_config``: the stage-1
        hyperparameters (else built from ``train``'s args)."""
        del local_rank  # accepted for signature parity
        self.level = level
        self.diffusion_path = diffusion_path
        self.device = resolve_device(device)
        self.work_dir = work_dir
        self.diffusion_config = diffusion_config
        self.trainer = None  # the last stage-1 trainer, kept for inspection
        self._components = None if components is None else components.to(self.device)

    @property
    def image_size(self) -> int:
        return 64 if self.diffusion_path.startswith("random:") else 1024

    def _load_components(self, unet_override_dir: Optional[str] = None):
        """The SD bundle; ``unet_override_dir`` (a fine-tuned UNet written by
        the JAX trainer) replaces its UNet and text projection."""
        from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
        from ldiffusion_tpu_torch.models.convert import load_unet_dir
        from ldiffusion_tpu_torch.models.unet import UNet2DCondition

        comps = self._components
        if comps is None:
            if not self.diffusion_path.startswith("random:"):
                raise NotImplementedError(
                    "reading a diffusers SD checkpoint directory is not ported yet "
                    "(ROADMAP queue 1 item 6); pass components=")
            comps = SDComponents.random(device=self.device)
        if unet_override_dir:
            cfg, unet_sd, proj_sd = load_unet_dir(unet_override_dir)
            dtype = comps.unet.conv_in.weight.dtype
            with torch.device("meta"):
                unet = UNet2DCondition(cfg)
            unet.to_empty(device=self.device).load_state_dict(unet_sd)
            comps.unet = unet.to(dtype=dtype, memory_format=torch.channels_last).eval()
            comps.unet_config = cfg
            if proj_sd is not None:
                comps.proj.load_state_dict(proj_sd)
        self._components = comps
        return comps

    def load_data(self, image_dir: str, label_dir: str, train_ratio: float = 0.7,
                  seed: int = 0):
        """70/30 split (reference ``ldiffusion.py:72-119``)."""
        images, labels = list_pairs(image_dir, label_dir)
        tr_i, tr_l, te_i, te_l = split_dataset(images, labels, train_ratio, seed)
        return (SegmentationDataset(tr_i, tr_l, self.level),
                SegmentationDataset(te_i, te_l, self.level))

    # ------------------------------------------------------------------
    def train(self, args, component: str = "all", ldiffusion_weight: Optional[str] = None):
        """``component="ldiffusion"``: stage-1 warm-up → {"ldiffusion": the
        saved UNet directory}. ``args``: image_dir, label_dir, batch_size,
        num_inference_steps, num_classes (the CLI's names)."""
        del ldiffusion_weight  # read by segmentor training, which is not ported yet
        if component != "ldiffusion":
            raise NotImplementedError(
                f"component={component!r}: segmentor training is not ported yet (ROADMAP "
                "queue 1 item 10); train component='ldiffusion'")
        train_ds, _ = self.load_data(args.image_dir, args.label_dir)
        print("Starting LDiffusion warming up...", flush=True)
        return {"ldiffusion": self.train_ldiffusion(args, train_ds)}

    def train_ldiffusion(self, args, train_ds: SegmentationDataset) -> str:
        from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

        comps = self._load_components()
        cfg = self.diffusion_config or DiffusionTrainConfig(
            batch_size=args.batch_size, num_inference_steps=args.num_inference_steps,
            num_classes=getattr(args, "num_classes", None))
        self.trainer = DiffusionWarmupTrainer(comps, cfg, work_dir=self.work_dir)
        steps = max(1, len(train_ds) // max(1, args.batch_size))
        it = train_ds.iter_batches(args.batch_size, image_size=cfg.latent_size,
                                   label_size=cfg.latent_size)
        return self.trainer.train(it, steps_per_epoch=steps)

    def inference(self, image_path: str, ldiffusion_weight: Optional[str],
                  segmentor_weight: str, num_classes: int):
        """Single-image inference → (diffusion-transformed PIL image, mask)."""
        if self.level == "tissue":
            return self.inference_tissue(image_path, ldiffusion_weight, segmentor_weight,
                                         num_classes)
        if self.level == "cell":
            raise NotImplementedError("the cell level is not ported yet "
                                      "(ROADMAP queue 1 item 11)")
        raise ValueError("Invalid level specified. Choose 'tissue' or 'cell'.")

    def _transform(self, img_norm: np.ndarray, emb):
        """(H, W, 3) ImageNet-normalised numpy → (H, W, 3) [0, 1] tensor."""
        from ldiffusion_tpu_torch.diffusion.pipeline import one_step_transform

        x = torch.from_numpy(img_norm).to(self.device)[None]
        return one_step_transform(self._components, x, emb)[0]

    def inference_tissue(self, image_path, ldiffusion_weight, segmentor_weight, num_classes,
                         output_path: Optional[str] = None, overwrite: bool = True):
        from ldiffusion_tpu_torch.diffusion.pipeline import trajectory_text_emb
        from ldiffusion_tpu_torch.segmentor.planner import SegPlan
        from ldiffusion_tpu_torch.segmentor.postprocess import (
            apply_postprocessing,
            load_postprocessing,
        )
        from ldiffusion_tpu_torch.segmentor.predictor import (
            SlidingWindowPredictor,
            find_fold_checkpoints,
        )

        print("Running inference on tissue-level model...", flush=True)
        self._load_components(unet_override_dir=ldiffusion_weight)
        plan = SegPlan.load(os.path.join(segmentor_weight, "plans.json"))
        ckpts = find_fold_checkpoints(segmentor_weight)
        predictor = SlidingWindowPredictor.from_checkpoints(plan, ckpts, device=self.device)
        pp_steps = []
        for cand in [segmentor_weight] + [os.path.dirname(c) for c in ckpts]:
            pp_path = os.path.join(cand, "postprocessing.json")
            if os.path.exists(pp_path):
                pp_steps = load_postprocessing(pp_path)
                break
        size = self.image_size

        with torch.inference_mode():
            emb = trajectory_text_emb(self._components, 1)

            def square(path, want_transformed: bool):
                t = self._transform(load_image(path, (size, size)), emb)
                mask = predictor.seg(t, normalize=True).cpu().numpy()
                return (t.cpu().numpy() if want_transformed else None), mask

            def finish(mask):
                return apply_postprocessing(mask, pp_steps) if pp_steps else mask

            if os.path.isdir(image_path):
                if not output_path:
                    raise ValueError("When image_path is a folder, output_path must be "
                                     "specified!")
                os.makedirs(output_path, exist_ok=True)
                for fn in sorted(os.listdir(image_path)):
                    out_png = os.path.join(output_path, os.path.splitext(fn)[0] + ".png")
                    if not overwrite and os.path.exists(out_png):
                        continue
                    path = os.path.join(image_path, fn)
                    with Image.open(path) as probe:
                        w, h = probe.size
                    if w == h:
                        _, mask = square(path, want_transformed=False)
                    else:
                        mask = predictor.predict(_plain_rgb(path)[1])
                    Image.fromarray(finish(mask)).save(out_png)
                return None, None

            with Image.open(image_path) as probe:
                w, h = probe.size
            if w == h:
                t, mask = square(image_path, want_transformed=True)
                decoded = Image.fromarray((np.clip(t, 0, 1) * 255).astype(np.uint8))
            else:
                # non-square images skip the diffusion transform
                decoded, arr = _plain_rgb(image_path)
                mask = predictor.predict(arr)
            return decoded, finish(mask)


def _plain_rgb(path: str):
    """(RGB PIL image, its (H, W, 3) float32 values in [0, 1])."""
    with Image.open(path) as f:
        pil = f.convert("RGB")
    return pil, np.asarray(pil, np.float32) / 255.0
