"""Tissue inference in plain PyTorch: the one-step SD transform of a ROI,
then nnU-Net's 2D prediction (z-score per channel, sliding window with
gaussian blending, mirror TTA, the folds' logits averaged). Returns the
logits, from which the mask is their argmax; the benchmark judges the
program's masks by them."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench.reference import diffusion, models


def compute_steps(size: int, patch: int, step_frac: float):
    """Evenly spread tile starts (nnU-Net's)."""
    if size <= patch:
        return [0]
    n = int(np.ceil((size - patch) / (patch * step_frac))) + 1
    actual = (size - patch) / (n - 1)
    return [int(round(i * actual)) for i in range(n)]


def gaussian_map(patch, sigma_scale: float = 1.0 / 8) -> torch.Tensor:
    """nnU-Net's importance map: a centred gaussian (sigma patch/8), the
    filter of a delta (separable: the outer product of the 1D filters, in
    float64), normalised to max 1 and floored at its least nonzero value."""
    from scipy.ndimage import gaussian_filter1d

    g = np.ones((), np.float64)
    for p in patch:
        delta = np.zeros(p, np.float64)
        delta[p // 2] = 1.0
        g = np.multiply.outer(g, gaussian_filter1d(delta, p * sigma_scale, mode="constant"))
    g = g / g.max()
    g[g == 0] = g[g > 0].min()
    return torch.from_numpy(g.astype(np.float32))


class Tissue:
    """The reference pipeline: ``state`` {"unet", "vae", "text", "proj"}
    state dicts and ``folds``, one DynUNet state dict a fold; ``prec``: the
    precision of the products."""

    def __init__(self, cfg: dict, state: dict, folds: list, device,
                 prec: models.Precision = None):
        prec = prec or models.Precision()
        self.cfg, self.device = cfg, torch.device(device)
        with torch.device("meta"):
            mods = {"unet": models.UNet(cfg["unet"]), "vae": models.VAE(cfg["vae"]),
                    "text": models.CLIPText(cfg["text_encoder"]),
                    "proj": models.Linear(cfg["text_encoder"]["hidden_size"],
                                          cfg["unet"]["cross_attention_dim"])}
        for key, m in mods.items():
            m.to_empty(device=self.device).load_state_dict(state[key])
            setattr(self, key, models.set_precision(m.eval(), prec))
        self.nets = []
        for sd in folds:
            with torch.device("meta"):
                net = models.DynUNet(cfg["plan"])
            net.to_empty(device=self.device).load_state_dict(sd)
            self.nets.append(models.set_precision(net.eval(), prec))
        plan = cfg["plan"]
        self.patch = tuple(plan["patch_size"])
        self.gauss = gaussian_map(self.patch).to(self.device)
        axes = [a + 2 for a in plan["mirror_axes"]]
        self.flips = [c for r in range(len(axes) + 1) for c in itertools.combinations(axes, r)]

    @torch.no_grad()
    def transform(self, rois_u8):
        """(B, H, W, 3) uint8 ROIs → (B, H, W, 3) transformed images in [0, 1]."""
        emb = diffusion.text_embedding(self.text, self.proj, 1)
        out = [diffusion.one_step_transform(self.unet, self.vae, emb,
                                            diffusion.normalise(roi[None].to(self.device)))
               for roi in rois_u8]
        return torch.cat(out)

    @torch.no_grad()
    def logits(self, image):
        """(H, W, 3) image → (classes, H, W) logits: z-scored per channel,
        zero-padded to the patch, tiled, each tile's logits averaged over the
        mirrors and weighted by the gaussian, blended, averaged over the folds."""
        x = image.float()
        mean = x.mean(dim=(0, 1), keepdim=True)
        std = x.std(dim=(0, 1), keepdim=True, correction=0).clamp_min(1e-8)
        x = ((x - mean) / std).permute(2, 0, 1)
        shape = x.shape[1:]
        pads = [max(0, p - s) for p, s in zip(self.patch, shape)]
        x = torch.nn.functional.pad(x, (0, pads[1], 0, pads[0]))
        frac = self.cfg["plan"]["tile_step_size"]
        steps = [compute_steps(n, p, frac) for n, p in zip(x.shape[1:], self.patch)]
        wins = [(slice(None),) + tuple(slice(s, s + p) for s, p in zip(start, self.patch))
                for start in itertools.product(*steps)]
        total = torch.zeros((self.cfg["plan"]["num_classes"], *x.shape[1:]), device=self.device)
        weight = torch.zeros((1, *x.shape[1:]), device=self.device)
        for win in wins:
            tile = x[win][None]
            batch = torch.cat([tile.flip(f) if f else tile for f in self.flips])
            fold_sum = 0.0
            for net in self.nets:
                out = net(batch)
                fold_sum = fold_sum + sum(out[i].flip([a - 1 for a in f]) if f else out[i]
                                          for i, f in enumerate(self.flips)) / len(self.flips)
            total[win] += fold_sum / len(self.nets) * self.gauss
            weight[win] += self.gauss
        return (total / weight)[:, :shape[0], :shape[1]]


def gaps(ref_logits, mask) -> dict:
    """How far below the reference's best logit the class ``mask`` chose
    lies at each pixel, in units of the reference's spread of logits about
    their per-pixel mean (RMS over classes and pixels): the mean over the
    pixels, the widest, and the share of pixels not at the reference's
    argmax. All 0 where every pixel takes the argmax."""
    m = torch.as_tensor(mask, device=ref_logits.device).long()
    gap = ref_logits.max(dim=0).values - ref_logits.gather(0, m[None])[0]
    spread = (ref_logits - ref_logits.mean(dim=0, keepdim=True)).square().mean().sqrt()
    gap = gap / spread
    return {"mean": float(gap.mean()), "widest": float(gap.max()),
            "share": float((gap > 0).float().mean())}
