"""Tiny cells for the CPU tests: the drivers' traffic at SD-style widths cut
far down, computed in float32, so that a run takes seconds on the CPU."""
from __future__ import annotations

import copy

from portbench import harness

UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
        "layers_per_block": 1, "cross_attention_dim": 32, "attention_head_dim": 2,
        "norm_num_groups": 8, "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]}
VAE = {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [32, 64],
       "layers_per_block": 1, "norm_num_groups": 8, "scaling_factor": 0.18215}
TEXT = {"vocab_size": 49408, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "max_position_embeddings": 77, "layer_norm_eps": 1e-05}


def stage1_cell(batch: int = 1, limits=None):
    cfg = copy.deepcopy(harness.load_json(harness.PKG, "configs", "sd15-stage1.json"))
    cfg.update(unet=UNET, vae=VAE, text_encoder=TEXT)
    cfg["train"]["compute_dtype"] = "float32"
    cell = {"name": "stage1-tiny", "config": "tiny", "chips": 1, "driver": "stage1",
            "traffic": {"name": "tiny", "batch": batch, "image_size": 32, "label_size": 64,
                        "classes": 7, "pool": 4, "checked_steps": 2},
            "why": "tiny", "limits": limits or {"grad_err": 1e-3, "change_gap": 1e-2}}
    return cell, cfg


def tissue_cell(limits=None):
    cfg = copy.deepcopy(harness.load_json(harness.PKG, "configs", "sd15-nnunet2d-tissue.json"))
    cfg.update(unet=UNET, vae=VAE, text_encoder=TEXT, dtype="float32", folds=2, roi_size=64)
    cfg["plan"].update(patch_size=[64, 64], features_per_stage=[8, 16, 32], strides=[1, 2, 2])
    cell = {"name": "tissue-tiny", "config": "tiny", "chips": 1, "driver": "tissue_folder",
            "traffic": {"name": "tiny", "rois": 3, "roi_size": 64,
                        "warmup_rois": 2, "checked_rois": 2},
            "why": "tiny", "limits": limits or {"mask_gap": 1e-3}}
    return cell, cfg


def run_tiny(cell, cfg, tmp, seed=7, seconds=0.0):
    """One CPU run of a tiny cell through the harness (its metrics are the
    readers' tests' to check); returns the result."""
    import torch

    from portbench import run as runner

    r = harness.Run(cell=cell, config=cfg, seed=seed, seconds=seconds, trace=False,
                    device=torch.device("cpu"), tmp=str(tmp))
    return runner.run_cell(r, harness.driver(cell["driver"]), {"end_to_end": [], "per_layer": []},
                           start=0.0)
