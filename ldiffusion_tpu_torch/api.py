"""Public API (counterpart of ``ldiffusion_tpu/api.py``): stage-1 and
stage-2 training and inference, at the tissue and the cell level.

    model = LDiffusionModel(diffusion_path, level="tissue")      # on cuda
    weights = model.train(args, component="all")   # {"ldiffusion": dir, "segmentor": path}
    decoded, mask = model.inference(image_path, weights["ldiffusion"],
                                    weights["segmentor"], num_classes)

``diffusion_path`` is a diffusers SD checkpoint directory (``unet/``,
``vae/``, ``text_encoder/``, optional ``tokenizer/``; safetensors or
``.bin``), read in bf16; ``random:<name>`` builds seeded random tiny
components; ``components=`` (an ``SDComponents`` bundle) wins over both.

Training splits the image/label pairs 70/30. ``component="ldiffusion"``:
``DiffusionWarmupTrainer`` on 64² images and labels; the UNet is saved in the
JAX trainer's directory layout. ``component="segmentor"`` (given
``ldiffusion_weight``) or ``"all"`` (after stage 1) trains the level's head
for ``max(1, num_epochs - 10)`` epochs on images passed through the one-step
diffusion transform of that UNet:
- tissue: the transformed images go into a ``DatasetXXX_Custom`` directory,
  which is fingerprinted, planned and preprocessed; fold 0 of a 5-fold split
  trains ``SegmentorTrainer``, then validates on the held-out 30%
  (``summary.json``, ``postprocessing.json``). The segmentor directory is
  readable by ``inference`` and by the JAX package's predictor.
- cell: ``CellSegClassifier`` (watershed proposer, frozen ResNet-152,
  trainable head) trains with ``CellTrainer``; the best validation micro-Dice
  head goes to ``work_dir/cellclassifier/<yy_mm_dd>/cellclassifier.pkl``,
  readable by the JAX package.

Tissue inference per ROI: CLIP text → projection, VAE ``encode_mean``, PNDM
one step through the UNet, ``decode_latents``, z-score, sliding-window
DynUNet with gaussian blending and 4-way mirror TTA → uint8 mask, as one
program per image shape (a captured CUDA graph from its second use on a
card; ``_make_fused_predict``); non-square images skip the diffusion
transform; in folder mode up to 3 images are in flight and existing outputs
are skipped unless ``overwrite``. Cell inference: the image is resized to the
square ROI and transformed, its instances proposed and classified, and the
mask (NEAREST) and the decoded image (BILINEAR) resized back to the image's
size. The ROI is 1024² unless ``diffusion_path`` starts with ``random:``
(then 64²).

The training command (``ldiffusion_tpu/api.py:51-66, 458-465``; reference
``ldiffusion.py:19-29, 326-331``), ``parse_args`` and ``main(argv,
device=None)``:

    python -m ldiffusion_tpu_torch.ldiffusion --diffusion-path P --image-dir I \
        --label-dir L --num-epochs N --batch-size B --num-inference-steps S --num-classes C

Under ``torch.distributed.run`` every process joins the process group
(``core/dist.py:maybe_init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo
with ``device="cpu"``) and the (data, fsdp, tensor) mesh of
``MeshConfig()`` (every process on ``data``), as ``ldiffusion_tpu/api.py:78-81``
does; stage 1 trains under FSDP2 over it, stage 2 under DDP, each process on
its rows of the global batch; rank 0 writes the files:

    python -m torch.distributed.run --nproc_per_node N -m ldiffusion_tpu_torch.ldiffusion ...

``--local_rank`` (or ``LOCAL_RANK``) picks the process's card. The dataset
transform, the plan and the split are made on rank 0 and shared; the cell
level trains the same on every process.
"""
from __future__ import annotations

import argparse
import collections
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ldiffusion_tpu_torch.core import tracing
from ldiffusion_tpu_torch.core.config import (
    DiffusionTrainConfig,
    MeshConfig,
    SegmentorTrainConfig,
)
from ldiffusion_tpu_torch.core.dist import (
    MeshContext,
    barrier,
    finish_distributed,
    make_mesh,
    maybe_init_distributed,
    on_main,
    process_device,
)
from ldiffusion_tpu_torch.data.dataset import (
    SegmentationDataset,
    list_pairs,
    load_image,
    split_dataset,
)


def parse_args(argv=None):
    """The JAX package's flags and defaults (reference ``ldiffusion.py:19-29``)."""
    p = argparse.ArgumentParser(description="Diffusion model training parameters")
    p.add_argument("--local_rank", type=int, default=int(os.environ.get("LOCAL_RANK", -1)))
    p.add_argument("--diffusion-path", type=str, required=True,
                   help="stable diffusion base model path")
    p.add_argument("--image-dir", type=str, required=True)
    p.add_argument("--label-dir", type=str, required=True)
    p.add_argument("--num-epochs", type=int, required=True)
    p.add_argument("--batch-size", type=int, required=True)
    p.add_argument("--num-inference-steps", type=int, required=True)
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--level", type=str, default="tissue", choices=["tissue", "cell"])
    p.add_argument("--component", type=str, default="all",
                   choices=["all", "ldiffusion", "segmentor"])
    return p.parse_args(argv)


class LDiffusionModel:
    def __init__(self, diffusion_path: str, level: str, local_rank: int = -1,
                 components=None, device=None, work_dir: str = "train_save",
                 diffusion_config: Optional[DiffusionTrainConfig] = None,
                 segmentor_config: Optional[SegmentorTrainConfig] = None,
                 mesh: Optional[MeshContext] = None):
        """``device``: None → the GPU (raises when there is none;
        ``cuda:LOCAL_RANK`` under a launcher, else ``cuda:local_rank`` when
        ``local_rank`` ≥ 0: ``core/dist.py:process_device``); pass ``"cpu"``
        to run on the CPU. ``mesh``: the
        processes to train over (else ``make_mesh(MeshConfig())`` after
        joining the launcher's process group, a single process without one).
        ``components``: an ``SDComponents`` bundle, moved to ``device``.
        ``diffusion_config``: the stage-1 hyperparameters (else built from
        ``train``'s args); ``segmentor_config``: the stage-2 ones (else the
        defaults with the epochs ``train`` derives)."""
        dev = process_device(device, local_rank)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        maybe_init_distributed(dev)
        self.mesh = mesh or make_mesh(MeshConfig(), dev)
        self.level = level
        self.diffusion_path = diffusion_path
        self.device = self.mesh.device
        self.work_dir = work_dir
        self.diffusion_config = diffusion_config
        self.segmentor_config = segmentor_config
        self.trainer = None  # the last stage-1 trainer, kept for inspection
        self.seg_trainer = None  # the last stage-2 trainer, kept for inspection
        self.cell_trainer = None  # the last cell trainer, kept for inspection
        self.cell_seconds = {}  # inference_cell's stages and counts, host clock
        self.prepare_seconds = {}  # _prepare_tissue's phases (host clock), its transform's programs
        self.tissue_programs = {}  # inference_tissue's program caches, kept for inspection
        self._components = None if components is None else components.to(self.device)

    @property
    def image_size(self) -> int:
        return 64 if self.diffusion_path.startswith("random:") else 1024

    def _load_components(self, unet_override_dir: Optional[str] = None):
        """The SD bundle: ``components=`` when given, else seeded random tiny
        weights for a ``random:`` path, else the diffusers checkpoint directory
        ``diffusion_path`` in bf16. ``unet_override_dir`` (a fine-tuned UNet
        written by the JAX trainer or ``save_unet_dir``) replaces its UNet and
        text projection."""
        from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents

        comps = self._components
        if comps is None:
            if self.diffusion_path.startswith("random:"):
                comps = SDComponents.random(device=self.device)
            else:
                comps = SDComponents.load(self.diffusion_path, dtype=torch.bfloat16,
                                          device=self.device)
        if unet_override_dir:
            comps.load_unet_override(unet_override_dir)
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
        """component ∈ {all, ldiffusion, segmentor} (``ldiffusion_tpu/api.py:120-141``)
        → the weight paths, {"ldiffusion": UNet dir, "segmentor": segmentor
        dir}. ``args``: image_dir, label_dir, num_epochs, batch_size,
        num_inference_steps, num_classes (the CLI's names)."""
        if self.level not in ("tissue", "cell"):
            raise ValueError("Invalid level specified. Choose 'tissue' or 'cell'.")
        if component not in ("all", "ldiffusion", "segmentor"):
            raise ValueError(f"component={component!r}: choose all, ldiffusion or segmentor")
        train_ds, val_ds = self.load_data(args.image_dir, args.label_dir)
        out = {}
        if component in ("all", "ldiffusion"):
            print("Starting LDiffusion warming up...", flush=True)
            ldiffusion_weight = self.train_ldiffusion(args, train_ds)
            out["ldiffusion"] = ldiffusion_weight
        if component in ("all", "segmentor"):
            print("Starting Segmentor training...", flush=True)
            if not ldiffusion_weight:
                raise ValueError("segmentor training needs ldiffusion_weight")
            seg_epochs = max(1, args.num_epochs - 10)  # reference ldiffusion.py:311
            train_head = self.train_tissue if self.level == "tissue" else self.train_cell
            out["segmentor"] = train_head(seg_epochs, ldiffusion_weight, args.num_classes,
                                          train_ds, val_ds)
        return out

    def train_ldiffusion(self, args, train_ds: SegmentationDataset) -> str:
        from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

        comps = self._load_components()
        cfg = self.diffusion_config or DiffusionTrainConfig(
            batch_size=args.batch_size, num_inference_steps=args.num_inference_steps,
            num_classes=getattr(args, "num_classes", None))
        self.trainer = DiffusionWarmupTrainer(comps, cfg, work_dir=self.work_dir, mesh=self.mesh)
        steps = max(1, len(train_ds) // max(1, args.batch_size))
        rows = self.mesh.row_slice(args.batch_size) if self.mesh.distributed else None
        it = train_ds.iter_batches(args.batch_size, image_size=cfg.latent_size,
                                   label_size=cfg.latent_size, rows=rows)
        return self.trainer.train(it, steps_per_epoch=steps)

    # -- stage 2: tissue -------------------------------------------------
    def _prepare_tissue(self, ldiffusion_weight: str, num_classes: int,
                        train_ds: SegmentationDataset, val_ds: SegmentationDataset) -> dict:
        """The fold-independent set-up (``ldiffusion_tpu/api.py:160-200``):
        diffusion-transform the dataset, check it, fingerprint, plan and
        preprocess every training case once."""
        from ldiffusion_tpu_torch.segmentor.dataset_builder import (
            DiffusionTransform,
            build_transformed_dataset,
            load_transformed_dataset,
        )
        from ldiffusion_tpu_torch.segmentor.fingerprint import (
            extract_fingerprint,
            verify_dataset_integrity,
        )
        from ldiffusion_tpu_torch.segmentor.planner import plan_experiment
        from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

        t0 = time.perf_counter()
        comps = self._load_components(unet_override_dir=ldiffusion_weight)
        t1 = time.perf_counter()
        print("\033[32m[LDiffusion] Preparing data by L-Diffusion...\033[0m", flush=True)
        transform = DiffusionTransform(comps)
        num, ds_path = on_main(
            build_transformed_dataset, train_ds.image_paths, train_ds.label_paths,
            val_ds.image_paths, val_ds.label_paths, num_classes, self.level,
            transform, os.path.join(self.work_dir, "seg_raw"), image_size=self.image_size)
        t2 = time.perf_counter()
        print("\033[32m[Segmentor] Data preprocessing and plan generation in "
              "progress...\033[0m", flush=True)
        images, labels = load_transformed_dataset(ds_path, "Tr")
        problems = verify_dataset_integrity(images, labels, num_classes)
        if problems:
            raise ValueError(f"dataset integrity check failed: {problems}")
        plan = plan_experiment(extract_fingerprint(images, labels), num_classes)
        out_dir = os.path.join(self.work_dir, "segmentor", f"Dataset{num:03d}")
        on_main(plan.save, os.path.join(out_dir, "plans.json"))
        pp_all = PreprocessedDataset.build(images, labels, num_classes)
        programs = transform.program.programs.values()
        self.prepare_seconds = {"load_unet_s": t1 - t0, "dataset_build_s": t2 - t1,
                                "rois": len(train_ds) + len(val_ds),
                                "transform_programs": len(programs),
                                "transform_replays": sum(p.replays for p in programs),
                                "plan_and_preprocess_s": time.perf_counter() - t2}
        return {"plan": plan, "out_dir": out_dir, "pp_all": pp_all, "ds_path": ds_path,
                "num_classes": num_classes}

    def _train_tissue_fold(self, prep: dict, epochs: int, fold) -> str:
        """Train one cross-validation fold (``ldiffusion_tpu/api.py:202-237``):
        ``splits_final.json`` beside ``plans.json``, checkpoints in
        ``fold_<f>/``, then the final validation on the held-out split. A
        failed validation is logged and the trained model kept, as in the JAX
        package."""
        from ldiffusion_tpu_torch.segmentor.dataset_builder import load_transformed_dataset
        from ldiffusion_tpu_torch.segmentor.splits import do_split
        from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

        plan, out_dir, pp_all = prep["plan"], prep["out_dir"], prep["pp_all"]
        tr_keys, va_keys = on_main(do_split, pp_all.keys(), fold,
                                   os.path.join(out_dir, "splits_final.json"))
        print(f"\033[32m[Segmentor] Training fold {fold} ({len(tr_keys)} train / "
              f"{len(va_keys)} val cases)...\033[0m", flush=True)
        cfg = self.segmentor_config or SegmentorTrainConfig(num_epochs=epochs)
        trainer = SegmentorTrainer(plan, cfg, output_dir=os.path.join(out_dir, f"fold_{fold}"),
                                   device=self.device, mesh=self.mesh)
        self.seg_trainer = trainer
        trainer.run_training(pp_all.subset(tr_keys), pp_all.subset(va_keys), num_epochs=epochs)
        val_images, val_labels = load_transformed_dataset(prep["ds_path"], "Ts")
        if not val_images:  # no held-out cases: the validation fold
            val_images = [pp_all[k].data for k in va_keys]
            val_labels = [np.maximum(pp_all[k].seg, 0) for k in va_keys]
        try:
            trainer.perform_actual_validation(val_images, val_labels)
        except Exception:  # validation must not lose the trained model
            print(f"final validation failed:\n{traceback.format_exc()}", flush=True)
        return out_dir

    def train_tissue(self, epochs: int, ldiffusion_weight: str, num_classes: int,
                     train_ds: SegmentationDataset, val_ds: SegmentationDataset,
                     fold=0) -> str:
        prep = self._prepare_tissue(ldiffusion_weight, num_classes, train_ds, val_ds)
        return self._train_tissue_fold(prep, epochs, fold)

    def train_tissue_all_folds(self, epochs: int, ldiffusion_weight: str, num_classes: int,
                               train_ds: SegmentationDataset, val_ds: SegmentationDataset,
                               folds=(0, 1, 2, 3, 4)) -> str:
        """Every cross-validation fold; inference fold-ensembles their
        checkpoints."""
        prep = self._prepare_tissue(ldiffusion_weight, num_classes, train_ds, val_ds)
        for f in folds:
            self._train_tissue_fold(prep, epochs, f)
        return prep["out_dir"]

    # -- stage 2: cell ----------------------------------------------------
    def train_cell(self, epochs: int, ldiffusion_weight: str, num_classes: int,
                   train_ds: SegmentationDataset, val_ds: SegmentationDataset) -> str:
        """Transform every train and validation ROI once, then ``CellTrainer``
        (``ldiffusion_tpu/api.py:260-281``). Returns the checkpoint path."""
        from ldiffusion_tpu_torch.cell.classifier import CellSegClassifier, CellTrainer
        from ldiffusion_tpu_torch.segmentor.dataset_builder import DiffusionTransform

        transform = DiffusionTransform(self._load_components(unet_override_dir=ldiffusion_weight))

        def pairs(ds):
            out = []
            for i in range(len(ds)):
                img, lab = ds.get(i, image_size=self.image_size)
                out.append((transform(img[None])[0], lab.astype(np.int32)))
            return out

        print("Cache L-Diffusion Augmented Inputs...", flush=True)
        self.cell_trainer = CellTrainer(CellSegClassifier(num_classes, device=self.device))
        return self.cell_trainer.train(pairs(train_ds), pairs(val_ds), epochs,
                                       save_dir=os.path.join(self.work_dir, "cellclassifier"))

    # ------------------------------------------------------------------
    def inference(self, image_path: str, ldiffusion_weight: Optional[str],
                  segmentor_weight: str, num_classes: int):
        """Single-image inference → (diffusion-transformed PIL image, mask)."""
        if self.level == "tissue":
            return self.inference_tissue(image_path, ldiffusion_weight, segmentor_weight,
                                         num_classes)
        if self.level == "cell":
            return self.inference_cell(image_path, ldiffusion_weight, segmentor_weight,
                                       num_classes)
        raise ValueError("Invalid level specified. Choose 'tissue' or 'cell'.")

    def _transform(self, img_norm: np.ndarray, emb):
        """(H, W, 3) ImageNet-normalised numpy → (H, W, 3) [0, 1] tensor."""
        from ldiffusion_tpu_torch.diffusion.pipeline import one_step_transform

        x = torch.from_numpy(img_norm).to(self.device)[None]
        return one_step_transform(self._components, x, emb)[0]

    def _make_fused_predict(self, predictor, emb):
        """The one-program tissue inference of a square image (the JAX
        package's ``_make_fused_predict``, ``ldiffusion_tpu/api.py:313-346``):
        ``run(img_norm, want_transformed)`` takes an (H, W, 3)
        ImageNet-normalised image (numpy or a tensor; a pinned host tensor is
        copied without blocking) and returns device tensors without syncing:
        the (H, W) uint8 mask, or (the (H, W, 3) [0, 1] float32 transform,
        the mask). One program per (shape, want_transformed) runs the
        one-step transform with the prompt embedding ``emb`` and the
        predictor's ``traced_seg`` (z-score, pad, window, label map): eager
        at its first use, a CUDA graph in the predictor's memory pool from
        its second (``core/graphs.py``), whose outputs hold until the next
        call. ``run.programs`` is the cache; it lives as long as ``run``."""
        from ldiffusion_tpu_torch.core.graphs import Program
        from ldiffusion_tpu_torch.diffusion.pipeline import one_step_transform

        comps = self._components
        programs = {}

        def run(img_norm, want_transformed: bool):
            if isinstance(img_norm, np.ndarray):
                img_norm = torch.from_numpy(img_norm)
            key = (tuple(img_norm.shape), bool(want_transformed))
            if key not in programs:
                def f(im):
                    t = one_step_transform(comps, im[None], emb)[0]
                    seg = predictor.traced_seg(t, normalize=True)
                    return (t, seg) if want_transformed else seg

                programs[key] = Program(f, self.device, predictor.graph_pool(),
                                        counted=[(predictor, "network_forwards")],
                                        name="tissue_fused")
            return programs[key](img_norm)

        run.programs = programs
        return run

    def inference_tissue(self, image_path, ldiffusion_weight, segmentor_weight, num_classes,
                         output_path: Optional[str] = None, overwrite: bool = True):
        """One ROI → (decoded PIL image, mask), or a folder of ROIs →
        ``output_path/<name>.png`` masks and (None, None). Square images go
        through the fused program (``_make_fused_predict``, whose cache lasts
        this call), the others through ``predictor.predict`` without the
        transform. In folder mode up to 3 square images are in flight (the
        JAX package's ``api.py:394-420``): each is read and resized into one
        of 3 pinned host buffers, copied to the program's input without
        blocking, run, and its mask copied into one of 3 pinned slots behind
        a CUDA event, while the host reads the next; with 3 pending the
        oldest is waited for, postprocessed and written, in sorted order.
        The call's program caches stay in ``tissue_programs``.

        Spans (``core/tracing.py``, while a ``torch.profiler`` session
        records): the call is ``tissue/call``; finding the checkpoints and
        building the predictor ``tissue/predictor_build``; in folder mode
        each image's probe, read and staging copy ``tissue/read_roi``, and
        its wait, postprocessing and PNG ``tissue/write_mask``, whose wait
        for the mask's event is ``tissue/wait_mask``."""
        with tracing.span("tissue/call"):
            return self._inference_tissue(image_path, ldiffusion_weight, segmentor_weight,
                                          num_classes, output_path, overwrite)

    def _inference_tissue(self, image_path, ldiffusion_weight, segmentor_weight, num_classes,
                          output_path, overwrite):
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
        with tracing.span("tissue/predictor_build"):
            ckpts = find_fold_checkpoints(segmentor_weight)
            predictor = SlidingWindowPredictor.from_checkpoints(plan, ckpts, device=self.device)
        pp_steps = []
        for cand in [segmentor_weight] + [os.path.dirname(c) for c in ckpts]:
            pp_path = os.path.join(cand, "postprocessing.json")
            if os.path.exists(pp_path):
                pp_steps = load_postprocessing(pp_path)
                break
        size = self.image_size

        def finish(mask):
            return apply_postprocessing(mask, pp_steps) if pp_steps else mask

        with torch.inference_mode():
            fused = self._make_fused_predict(predictor, trajectory_text_emb(self._components, 1))
            self.tissue_programs = {"fused": fused.programs, "predict": predictor._predict_cache}
            if os.path.isdir(image_path):
                if not output_path:
                    raise ValueError("When image_path is a folder, output_path must be "
                                     "specified!")
                os.makedirs(output_path, exist_ok=True)
                self._tissue_folder(image_path, output_path, overwrite, fused, predictor,
                                    finish)
                return None, None

            with Image.open(image_path) as probe:
                w, h = probe.size
            if w == h:
                t, mask = fused(load_image(image_path, (size, size)), want_transformed=True)
                t, mask = t.cpu().numpy(), mask.cpu().numpy()
                decoded = Image.fromarray((np.clip(t, 0, 1) * 255).astype(np.uint8))
            else:
                # non-square images skip the diffusion transform
                decoded, arr = _plain_rgb(image_path)
                mask = predictor.predict(arr)
            return decoded, finish(mask)

    def _tissue_folder(self, image_path, output_path, overwrite, fused, predictor, finish):
        """Folder mode of ``inference_tissue`` (its docstring)."""
        size = self.image_size
        pin = self.device.type == "cuda"
        staging = [torch.empty((size, size, 3), pin_memory=pin) for _ in range(3)]
        slots = [torch.empty((size, size), dtype=torch.uint8, pin_memory=pin)
                 for _ in range(3)]
        pending = collections.deque()  # (out_png, host mask or pinned slot, event)

        def write(png, mask, done):
            with tracing.span("tissue/write_mask"):
                if done is not None:
                    with tracing.span("tissue/wait_mask"):
                        done.synchronize()
                mask = mask.numpy().copy() if isinstance(mask, torch.Tensor) else mask
                Image.fromarray(finish(mask)).save(png)

        squares = 0
        for fn in sorted(os.listdir(image_path)):
            out_png = os.path.join(output_path, os.path.splitext(fn)[0] + ".png")
            if not overwrite and os.path.exists(out_png):
                continue
            path = os.path.join(image_path, fn)
            with tracing.span("tissue/read_roi"):
                with Image.open(path) as probe:
                    square = probe.size[0] == probe.size[1]
                if square:
                    # the buffers of square n - 3 are free: it left ``pending``
                    i = squares % 3
                    squares += 1
                    staging[i].numpy()[...] = load_image(path, (size, size))
                else:
                    rgb = _plain_rgb(path)[1]
            if square:
                slots[i].copy_(fused(staging[i], want_transformed=False), non_blocking=True)
                done = None
                if pin:
                    done = torch.cuda.Event()
                    done.record()
                pending.append((out_png, slots[i], done))
            else:
                pending.append((out_png, predictor.predict(rgb), None))
            if len(pending) >= 3:
                write(*pending.popleft())
        while pending:
            write(*pending.popleft())

    def inference_cell(self, image_path, ldiffusion_weight, segmentor_weight, num_classes):
        """One ROI at the cell level (``ldiffusion_tpu/api.py:438-455``) →
        (decoded PIL image, (H, W) uint8 class mask), both at the image's
        size. ``segmentor_weight``: a checkpoint, or a directory holding
        ``cellclassifier.pkl``. Host seconds of each stage go to
        ``cell_seconds``."""
        from ldiffusion_tpu_torch.cell.classifier import CellSegClassifier
        from ldiffusion_tpu_torch.diffusion.pipeline import trajectory_text_emb

        print("Running inference on cell-level model...", flush=True)
        self._load_components(unet_override_dir=ldiffusion_weight)
        model = CellSegClassifier(num_classes, device=self.device)
        ckpt = segmentor_weight
        if os.path.isdir(ckpt):
            ckpt = os.path.join(ckpt, "cellclassifier.pkl")
        model.load(ckpt)
        with Image.open(image_path) as probe:
            w, h = probe.size
        size = self.image_size
        t0 = time.perf_counter()
        with torch.inference_mode():
            t = self._transform(load_image(image_path, (size, size)),
                                trajectory_text_emb(self._components, 1))
            arr = t.float().cpu().numpy()
        t1 = time.perf_counter()
        mask = model.predict_mask(arr)
        self.cell_seconds = {"transform_s": t1 - t0, **model.last_predict}
        decoded = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
        mask = np.asarray(Image.fromarray(mask).resize((w, h), Image.NEAREST))
        return decoded.resize((w, h), Image.BILINEAR), mask


def _plain_rgb(path: str):
    """(RGB PIL image, its (H, W, 3) float32 values in [0, 1])."""
    with Image.open(path) as f:
        pil = f.convert("RGB")
    return pil, np.asarray(pil, np.float32) / 255.0


def main(argv=None, device=None):
    """The training command: ``LDiffusionModel(...).train(args,
    component=args.component)`` on ``device`` (None: the card). Returns the
    weight paths."""
    args = parse_args(argv)
    if int(os.environ.get("RANK", "0")) == 0:
        print("\033[35m" + str(vars(args)) + "\033[0m")
    model = LDiffusionModel(args.diffusion_path, level=args.level, local_rank=args.local_rank,
                            device=device)
    out = model.train(args, component=args.component)
    barrier("train_done")  # rank 0's files are written before any process exits
    finish_distributed()
    return out
