"""VGG19 feature extractor for the content loss (counterpart of
``ldiffusion_tpu/models/vgg.py``): ``torchvision.models.vgg19().features``,
configuration E, ending after pool5 — (B, 512, H/32, W/32) for an NCHW input.
The module tree is torchvision's (``features.N``), so a torchvision state dict
loads as it is; ``vgg_from_flax`` converts the JAX package's ``conv_i`` tree.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# VGG-19 configuration "E": conv channel counts with 'M' maxpools.
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _conv_layer_ids():
    """Indices of the convolutions in ``features`` (conv, ReLU; pools between)."""
    ids, i = [], 0
    for v in _CFG:
        if v == "M":
            i += 1
        else:
            ids.append(i)
            i += 2
    return ids


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        """x: (B, 3, H, W) → (B, 512, H/32, W/32), float32."""
        return self.features(x.to(self.features[0].weight.dtype)).float()


def convert_vgg19(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg19 state dict → this module's (its ``features.*``
    entries; the classifier is dropped)."""
    return {k: torch.as_tensor(v) for k, v in sd.items() if k.startswith("features.")}


def vgg_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG19Features parameters ({"conv_i": {"kernel" HWIO,
    "bias"}}, with or without the {"params": ...} wrapper) → state dict."""
    params = params["params"] if set(params) == {"params"} else params
    sd = {}
    for i, lid in enumerate(_conv_layer_ids()):
        node = params[f"conv_{i}"]
        w = np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"features.{lid}.weight"] = torch.tensor(np.ascontiguousarray(w))
        sd[f"features.{lid}.bias"] = torch.tensor(np.asarray(node["bias"], np.float32))
    return sd
