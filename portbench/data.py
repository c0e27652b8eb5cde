"""Seeded inputs, made in bulk on the device: tissue-like RGB ROIs and label
maps with every class present.

A ROI is a coarse random colour field (one value per 64² cell), upsampled
bicubically, with faint pixel noise, as uint8: smooth regions and edges,
like H&E tissue at the sizes that matter to the models. A label map is a
Voronoi partition of the map around 16 random sites, the first ``classes``
of which carry the classes in order, so every class is present.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LABEL_SITES = 16


def tissue_rois(n: int, size: int, generator, device) -> torch.Tensor:
    """(n, size, size, 3) uint8."""
    cells = max(size // 64, 2)
    coarse = torch.rand((n, 3, cells, cells), generator=generator, device=device) * 255.0
    field = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    field += torch.randn(field.shape, generator=generator, device=device) * 8.0
    return field.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def label_maps(n: int, size: int, classes: int, generator, device) -> torch.Tensor:
    """(n, size, size) int32 class ids, every class present in each map."""
    sites = torch.rand((n, LABEL_SITES, 2), generator=generator, device=device) * size
    site_class = torch.randint(0, classes, (n, LABEL_SITES), generator=generator, device=device)
    site_class[:, :classes] = torch.arange(classes, device=device)
    ys, xs = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32) + 0.5,
                            torch.arange(size, device=device, dtype=torch.float32) + 0.5,
                            indexing="ij")
    grid = torch.stack([ys, xs], dim=-1).reshape(1, -1, 1, 2)
    nearest = (grid - sites[:, None]).square().sum(-1).argmin(dim=-1)  # (n, size²)
    labels = torch.gather(site_class, 1, nearest)
    # each class's own site pixel carries it, whatever the partition gave
    pix = sites[:, :classes].long().clamp_(0, size - 1)
    labels.scatter_(1, pix[..., 0] * size + pix[..., 1], site_class[:, :classes])
    return labels.reshape(n, size, size).to(torch.int32)
