"""Weights between the JAX package's flax trees and the port's state dicts.

``*_from_flax`` take a flax parameter tree (nested dicts of numpy arrays, with
or without the ``{"params": ...}`` wrapper) and return the port's
``state_dict``; ``*_to_flax`` go the other way. The key tables are this
package's own copy of ``ldiffusion_tpu/models/convert.py:75-213`` (diffusers
names on the torch side). Layouts: conv OIHW ↔ HWIO, dense (out, in) ↔
(in, out), norms weight ↔ scale, embeddings as they are. The DynUNet's
``nn.ConvTranspose`` (padding "SAME", ``transpose_kernel=False``) is a
correlation with the kernel as stored, where torch's ``ConvTranspose2d``
convolves: its (in, out, kh, kw) weight is the flax kernel spatially flipped.
The ControlNet (``controlnet_rows``) shares the UNet's encoder rows; the
conductor nets' BatchNorm rows (kind ``bn``) also carry flax's
``batch_stats`` as the running statistics, and a ConvNeXt block's ``gamma``
is a bare parameter (kind ``param``).

Also reads the two artifacts the JAX trainers write: the fine-tuned UNet
directory (``unet_params.npz`` + ``unet_config.json`` + ``proj_weights.npz``)
and, through ``core/checkpoint.py``, the segmentor's pickles; and writes the
first (``save_unet_dir``) in the same layout, readable by the JAX package's
``load_unet_dir`` and by this one's.

``load_sd_component`` reads one component of a diffusers SD checkpoint
directory (``ldiffusion_tpu/models/convert.py:220-279``): the port's modules
carry the diffusers names, so it only renames the legacy VAE attention keys
and drops CLIP's ``position_ids`` buffer; the caller loads the result with
``load_state_dict(strict=True)``, so a missing key raises.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig
from ldiffusion_tpu_torch.models.dynunet import DynUNetConfig, encoder_blocks
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3DConfig
from ldiffusion_tpu_torch.models.resnet import ResNetConfig
from ldiffusion_tpu_torch.models.safetensors_io import load_state_dict
from ldiffusion_tpu_torch.models.unet import UNet2DConditionConfig
from ldiffusion_tpu_torch.models.vae import VAEConfig

# kind → (torch leaf, flax leaf)
_LEAVES = {"conv": ("weight", "kernel"), "convT": ("weight", "kernel"),
           "linear": ("weight", "kernel"), "norm": ("weight", "scale"),
           "bn": ("weight", "scale"), "embed": ("weight", "embedding"),
           "param": ("gamma", "gamma")}
Row = Tuple[str, str, str]  # (torch prefix, flax path, kind)


def _torch_layout(kind: str, w: np.ndarray) -> np.ndarray:
    """flax → torch; convolutions of any spatial rank (2D and 3D)."""
    nd = w.ndim - 2
    if kind == "conv":
        return w.transpose(nd + 1, nd, *range(nd))
    if kind == "convT":
        return w[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd))
    if kind == "linear":
        return w.T
    return w


def _flax_layout(kind: str, w: np.ndarray) -> np.ndarray:
    nd = w.ndim - 2
    if kind == "conv":
        return w.transpose(*range(2, nd + 2), 1, 0)
    if kind == "convT":
        return w.transpose(*range(2, nd + 2), 0, 1)[(slice(None, None, -1),) * nd]
    if kind == "linear":
        return w.T
    return w


def _unwrap(params: dict) -> dict:
    return params["params"] if set(params) == {"params"} else params


def _node(tree: dict, path: str) -> dict:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _set(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def from_flax(rows: List[Row], params: dict) -> Dict[str, torch.Tensor]:
    params = _unwrap(params)
    sd = {}
    for tp, fp, kind in rows:
        node = _node(params, fp)
        tw, fw = _LEAVES[kind]
        w = _torch_layout(kind, np.asarray(node[fw], np.float32))
        sd[f"{tp}.{tw}"] = torch.tensor(np.ascontiguousarray(w))
        if "bias" in node:
            sd[f"{tp}.bias"] = torch.tensor(np.asarray(node["bias"], np.float32))
    return sd


def to_flax(rows: List[Row], state_dict: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for tp, fp, kind in rows:
        tw, fw = _LEAVES[kind]
        w = state_dict[f"{tp}.{tw}"].detach().float().cpu().numpy()
        _set(tree, f"{fp}/{fw}", np.ascontiguousarray(_flax_layout(kind, w)))
        if f"{tp}.bias" in state_dict:
            _set(tree, f"{fp}/bias", state_dict[f"{tp}.bias"].detach().float().cpu().numpy())
    return tree


# ---------------------------------------------------------------------------
# key tables
# ---------------------------------------------------------------------------

def _resnet(rows, tp, fp, has_time, has_shortcut):
    rows += [(f"{tp}.norm1", f"{fp}/norm1", "norm"), (f"{tp}.conv1", f"{fp}/conv1", "conv")]
    if has_time:
        rows.append((f"{tp}.time_emb_proj", f"{fp}/time_emb_proj", "linear"))
    rows += [(f"{tp}.norm2", f"{fp}/norm2", "norm"), (f"{tp}.conv2", f"{fp}/conv2", "conv")]
    if has_shortcut:
        rows.append((f"{tp}.conv_shortcut", f"{fp}/conv_shortcut", "conv"))


def _transformer2d(rows, tp, fp, depth: int = 1):
    rows += [(f"{tp}.norm", f"{fp}/norm", "norm"), (f"{tp}.proj_in", f"{fp}/proj_in", "conv")]
    for i in range(depth):
        b, fb = f"{tp}.transformer_blocks.{i}", f"{fp}/transformer_blocks_{i}"
        rows += [(f"{b}.{n}", f"{fb}/{n}", "norm") for n in ("norm1", "norm2", "norm3")]
        for attn in ("attn1", "attn2"):
            rows += [(f"{b}.{attn}.{p}", f"{fb}/{attn}/{p}", "linear")
                     for p in ("to_q", "to_k", "to_v")]
            rows.append((f"{b}.{attn}.to_out.0", f"{fb}/{attn}/to_out", "linear"))
        rows += [(f"{b}.ff.net.0.proj", f"{fb}/ff/proj_in", "linear"),
                 (f"{b}.ff.net.2", f"{fb}/ff/proj_out", "linear")]
    rows.append((f"{tp}.proj_out", f"{fp}/proj_out", "conv"))


def _unet_encoder_rows(rows, config: UNet2DConditionConfig) -> None:
    """time embedding, the down path and the mid block: the UNet's and the
    ControlNet's alike."""
    rows += [("time_embedding.linear_1", "time_embedding/linear_1", "linear"),
             ("time_embedding.linear_2", "time_embedding/linear_2", "linear")]
    n = len(config.block_out_channels)
    in_ch = config.block_out_channels[0]
    for i, btype in enumerate(config.down_block_types):
        ch = config.block_out_channels[i]
        for j in range(config.layers_per_block):
            _resnet(rows, f"down_blocks.{i}.resnets.{j}", f"down_{i}_resnet_{j}", True,
                    j == 0 and ch != in_ch)
            if btype == "CrossAttnDownBlock2D":
                _transformer2d(rows, f"down_blocks.{i}.attentions.{j}", f"down_{i}_attn_{j}")
        in_ch = ch
        if i < n - 1:
            rows.append((f"down_blocks.{i}.downsamplers.0.conv",
                         f"down_{i}_downsample/conv", "conv"))
    _resnet(rows, "mid_block.resnets.0", "mid_resnet_0", True, False)
    _transformer2d(rows, "mid_block.attentions.0", "mid_attn")
    _resnet(rows, "mid_block.resnets.1", "mid_resnet_1", True, False)


def unet_rows(config: UNet2DConditionConfig) -> List[Row]:
    rows: List[Row] = [("conv_in", "conv_in", "conv")]
    _unet_encoder_rows(rows, config)
    n = len(config.block_out_channels)
    for i, btype in enumerate(config.up_block_types):
        for j in range(config.layers_per_block + 1):
            _resnet(rows, f"up_blocks.{i}.resnets.{j}", f"up_{i}_resnet_{j}", True, True)
            if btype == "CrossAttnUpBlock2D":
                _transformer2d(rows, f"up_blocks.{i}.attentions.{j}", f"up_{i}_attn_{j}")
        if i < n - 1:
            rows.append((f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}_upsample/conv", "conv"))
    rows += [("conv_norm_out", "conv_norm_out", "norm"), ("conv_out", "conv_out", "conv")]
    return rows


def controlnet_rows(config: UNet2DConditionConfig,
                    conditioning_embed_channels: Tuple[int, ...]) -> List[Row]:
    """``models/controlnet.py``'s names ↔ ``ldiffusion_tpu/models/controlnet.py``'s:
    the conditioning stages ``blocks.{2i, 2i+1}`` ↔ ``cond_{i}_{a, b}``, the
    zero convolutions ``controlnet_down_blocks.k`` ↔ ``zero_conv_k``."""
    e = "controlnet_cond_embedding"
    rows: List[Row] = [(f"{e}.conv_in", "cond_in", "conv")]
    for i in range(len(conditioning_embed_channels) - 1):
        rows += [(f"{e}.blocks.{2 * i}", f"cond_{i}_a", "conv"),
                 (f"{e}.blocks.{2 * i + 1}", f"cond_{i}_b", "conv")]
    rows += [(f"{e}.conv_out", "cond_out", "conv"), ("conv_in", "conv_in", "conv")]
    _unet_encoder_rows(rows, config)
    n = len(config.block_out_channels)
    n_zero = 1 + n * config.layers_per_block + (n - 1)  # conv_in, each layer, each downsample
    rows += [(f"controlnet_down_blocks.{k}", f"zero_conv_{k}", "conv") for k in range(n_zero)]
    rows.append(("controlnet_mid_block", "zero_conv_mid", "conv"))
    return rows


def _vae_attn(rows, tp, fp):
    rows.append((f"{tp}.group_norm", f"{fp}/group_norm", "norm"))
    rows += [(f"{tp}.{p}", f"{fp}/{p}", "linear") for p in ("to_q", "to_k", "to_v")]
    rows.append((f"{tp}.to_out.0", f"{fp}/to_out", "linear"))


def vae_rows(config: VAEConfig) -> List[Row]:
    rows: List[Row] = [("encoder.conv_in", "encoder/conv_in", "conv")]
    chans = config.block_out_channels
    n = len(chans)
    in_ch = chans[0]
    for i, ch in enumerate(chans):
        for j in range(config.layers_per_block):
            _resnet(rows, f"encoder.down_blocks.{i}.resnets.{j}",
                    f"encoder/down_{i}_resnet_{j}", False, j == 0 and ch != in_ch)
        in_ch = ch
        if i < n - 1:
            rows.append((f"encoder.down_blocks.{i}.downsamplers.0.conv",
                         f"encoder/down_{i}_downsample/conv", "conv"))
    for part in ("encoder", "decoder"):
        if part == "decoder":
            rows.append(("decoder.conv_in", "decoder/conv_in", "conv"))
        _resnet(rows, f"{part}.mid_block.resnets.0", f"{part}/mid_resnet_0", False, False)
        _vae_attn(rows, f"{part}.mid_block.attentions.0", f"{part}/mid_attn")
        _resnet(rows, f"{part}.mid_block.resnets.1", f"{part}/mid_resnet_1", False, False)
        if part == "encoder":
            rows += [("encoder.conv_norm_out", "encoder/conv_norm_out", "norm"),
                     ("encoder.conv_out", "encoder/conv_out", "conv")]
    rev = list(reversed(chans))
    in_ch = rev[0]
    for i, ch in enumerate(rev):
        for j in range(config.layers_per_block + 1):
            _resnet(rows, f"decoder.up_blocks.{i}.resnets.{j}",
                    f"decoder/up_{i}_resnet_{j}", False, j == 0 and ch != in_ch)
        in_ch = ch
        if i < n - 1:
            rows.append((f"decoder.up_blocks.{i}.upsamplers.0.conv",
                         f"decoder/up_{i}_upsample/conv", "conv"))
    rows += [("decoder.conv_norm_out", "decoder/conv_norm_out", "norm"),
             ("decoder.conv_out", "decoder/conv_out", "conv"),
             ("quant_conv", "quant_conv", "conv"),
             ("post_quant_conv", "post_quant_conv", "conv")]
    return rows


def clip_text_rows(num_layers: int) -> List[Row]:
    p = "text_model."
    rows: List[Row] = [(f"{p}embeddings.token_embedding", "token_embedding", "embed"),
                       (f"{p}embeddings.position_embedding", "position_embedding", "embed")]
    for i in range(num_layers):
        t, f = f"{p}encoder.layers.{i}", f"layers_{i}"
        rows += [(f"{t}.self_attn.{q}", f"{f}/self_attn/{q}", "linear")
                 for q in ("q_proj", "k_proj", "v_proj", "out_proj")]
        rows += [(f"{t}.layer_norm1", f"{f}/layer_norm1", "norm"),
                 (f"{t}.layer_norm2", f"{f}/layer_norm2", "norm"),
                 (f"{t}.mlp.fc1", f"{f}/fc1", "linear"),
                 (f"{t}.mlp.fc2", f"{f}/fc2", "linear")]
    rows.append((f"{p}final_layer_norm", "final_layer_norm", "norm"))
    return rows


def dynunet_rows(config) -> List[Row]:
    """Plain blocks ``enc_{s}_{c}/{conv,norm}``; residual encoder blocks
    ``enc_{s}_{c}/{conv1,norm1,conv2,norm2}`` and, where the shape changes,
    ``downsample_{conv,norm}`` (``ldiffusion_tpu/models/dynunet.py:121-153``).
    ``config``: a ``DynUNetConfig`` (int strides) or a ``DynUNet3DConfig``
    (per-axis strides); both nets name their modules alike."""
    rows: List[Row] = []
    cin = config.in_channels
    for s, n_blocks in enumerate(encoder_blocks(config)):
        feats = config.features_per_stage[s]
        for c in range(n_blocks):
            t, f = f"enc_{s}_{c}", f"enc_{s}_{c}"
            if config.block_type == "plain":
                rows += [(f"{t}.conv", f"{f}/conv", "conv"), (f"{t}.norm", f"{f}/norm", "norm")]
            else:
                for i in (1, 2):
                    rows += [(f"{t}.conv{i}", f"{f}/conv{i}", "conv"),
                             (f"{t}.norm{i}", f"{f}/norm{i}", "norm")]
                if (c == 0 and max(np.atleast_1d(config.strides[s])) > 1) or cin != feats:
                    rows += [(f"{t}.downsample_conv", f"{f}/downsample_conv", "conv"),
                             (f"{t}.downsample_norm", f"{f}/downsample_norm", "norm")]
            cin = feats
    for d in range(config.n_stages - 2, -1, -1):
        rows.append((f"up_{d}", f"up_{d}", "convT"))
        for c in range(config.n_conv_per_stage):
            rows += [(f"dec_{d}_{c}.conv", f"dec_{d}_{c}/conv", "conv"),
                     (f"dec_{d}_{c}.norm", f"dec_{d}_{c}/norm", "norm")]
        if config.deep_supervision or d == 0:
            rows.append((f"seg_{d}", f"seg_{d}", "conv"))
    return rows


def resnet_rows(config: ResNetConfig) -> List[Row]:
    """torchvision's names ↔ ``ldiffusion_tpu/models/resnet.py``'s; the first
    block of every stage has the projection shortcut."""
    rows: List[Row] = [("conv1", "conv1", "conv"), ("bn1", "bn1", "norm")]
    for i, n_blocks in enumerate(config.stage_sizes):
        for j in range(n_blocks):
            t, f = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for c in (1, 2, 3):
                rows += [(f"{t}.conv{c}", f"{f}/conv{c}", "conv"),
                         (f"{t}.bn{c}", f"{f}/bn{c}", "norm")]
            if j == 0:
                rows += [(f"{t}.downsample.0", f"{f}/downsample_conv", "conv"),
                         (f"{t}.downsample.1", f"{f}/downsample_bn", "norm")]
    return rows


# the cell classifier's head: {"adapter": 3×3 conv, "classifier": dense}
CELL_HEAD_ROWS: List[Row] = [("adapter", "adapter", "conv"),
                             ("classifier", "classifier", "linear")]


def unet_from_flax(params, config: UNet2DConditionConfig):
    return from_flax(unet_rows(config), params)


def unet_to_flax(state_dict, config: UNet2DConditionConfig):
    return to_flax(unet_rows(config), state_dict)


def vae_from_flax(params, config: VAEConfig):
    return from_flax(vae_rows(config), params)


def vae_to_flax(state_dict, config: VAEConfig):
    return to_flax(vae_rows(config), state_dict)


def clip_text_from_flax(params, num_layers: int):
    return from_flax(clip_text_rows(num_layers), params)


def clip_text_to_flax(state_dict, num_layers: int):
    return to_flax(clip_text_rows(num_layers), state_dict)


def dynunet_from_flax(params, config: DynUNetConfig, batch_stats=None):
    """``batch_stats`` (a BatchNorm net's ``{path: {"mean", "var"}}``
    collection) adds the norms' running statistics; without it the state
    dict holds the parameters only (as for optimizer buffers)."""
    sd = from_flax(dynunet_rows(config), params)
    if batch_stats:
        for tp, fp, kind in dynunet_rows(config):
            if kind == "norm":
                node = _node(batch_stats, fp)
                sd[f"{tp}.running_mean"] = torch.tensor(np.asarray(node["mean"], np.float32))
                sd[f"{tp}.running_var"] = torch.tensor(np.asarray(node["var"], np.float32))
    return sd


def dynunet_to_flax(state_dict, config: DynUNetConfig):
    return to_flax(dynunet_rows(config), state_dict)


def dynunet3d_from_flax(params, config: DynUNet3DConfig):
    """``ldiffusion_tpu/models/dynunet3d.py``'s tree (plain or residual
    blocks) → ``DynUNet3D``'s state dict."""
    return from_flax(dynunet_rows(config), params)


def dynunet3d_to_flax(state_dict, config: DynUNet3DConfig):
    return to_flax(dynunet_rows(config), state_dict)


def dynunet_batch_stats_to_flax(state_dict, config: DynUNetConfig) -> dict:
    """The running statistics as flax's ``batch_stats`` collection; ``{}``
    for InstanceNorm nets, as the JAX trainer writes."""
    stats: dict = {}
    if getattr(config, "norm", "instance") == "batch":
        for tp, fp, kind in dynunet_rows(config):
            if kind == "norm":
                for t, f in (("running_mean", "mean"), ("running_var", "var")):
                    _set(stats, f"{fp}/{f}",
                         state_dict[f"{tp}.{t}"].detach().float().cpu().numpy())
    return stats


def resnet_from_flax(variables: dict, config: ResNetConfig) -> Dict[str, torch.Tensor]:
    """The JAX encoder's ``{"params", "batch_stats"}`` → the port's state dict
    (BatchNorm running statistics from ``batch_stats``)."""
    rows = resnet_rows(config)
    sd = from_flax(rows, variables["params"])
    for tp, fp, kind in rows:
        if kind == "norm":
            node = _node(variables["batch_stats"], fp)
            sd[f"{tp}.running_mean"] = torch.tensor(np.asarray(node["mean"], np.float32))
            sd[f"{tp}.running_var"] = torch.tensor(np.asarray(node["var"], np.float32))
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0)
    return sd


def resnet_to_flax(state_dict, config: ResNetConfig) -> dict:
    rows = resnet_rows(config)
    stats: dict = {}
    for tp, fp, kind in rows:
        if kind == "norm":
            for t, f in (("running_mean", "mean"), ("running_var", "var")):
                _set(stats, f"{fp}/{f}", state_dict[f"{tp}.{t}"].detach().float().cpu().numpy())
    return {"params": to_flax(rows, state_dict), "batch_stats": stats}


def _basic_conv(rows, tp, fp):
    rows += [(f"{tp}.conv", f"{fp}/conv", "conv"), (f"{tp}.bn", f"{fp}/bn", "bn")]


def _convnext_rows(rows, tp, fp, dims, depths):
    rows += [(f"{tp}.stem_conv", f"{fp}/stem_conv", "conv"),
             (f"{tp}.stem_norm", f"{fp}/stem_norm", "norm")]
    for i, depth in enumerate(depths):
        if i > 0:
            rows += [(f"{tp}.down_{i}_norm", f"{fp}/down_{i}_norm", "norm"),
                     (f"{tp}.down_{i}_conv", f"{fp}/down_{i}_conv", "conv")]
        for j in range(depth):
            b, fb = f"{tp}.stage_{i}_block_{j}", f"{fp}/stage_{i}_block_{j}"
            rows += [(f"{b}.dwconv", f"{fb}/dwconv", "conv"), (f"{b}.norm", f"{fb}/norm", "norm"),
                     (f"{b}.pwconv1", f"{fb}/pwconv1", "linear"),
                     (f"{b}.pwconv2", f"{fb}/pwconv2", "linear"), (b, fb, "param")]


def _cbam_aspp_rows(rows, n_dilations: int = 4):
    rows += [("cbam.channel_att.fc1", "cbam/channel_att/fc1", "linear"),
             ("cbam.channel_att.fc2", "cbam/channel_att/fc2", "linear"),
             ("cbam.spatial_att.conv", "cbam/spatial_att/conv", "conv")]
    for name in [f"branch_{i}" for i in range(n_dilations)] + ["global_branch", "project"]:
        _basic_conv(rows, f"aspp.{name}", f"aspp/{name}")


def tissue_seg_net_rows(config) -> List[Row]:
    """``models/conductor.py``'s ``TissueSegNet`` ↔ the JAX module's (the same
    names; ConvNeXt ``gamma`` a bare parameter; BatchNorm rows of kind
    ``bn``, whose running statistics are flax's ``batch_stats``)."""
    rows: List[Row] = []
    _convnext_rows(rows, "backbone", "backbone", config.backbone_dims, config.backbone_depths)
    _cbam_aspp_rows(rows)
    _basic_conv(rows, "decoder_conv", "decoder_conv")
    rows.append(("decoder_out", "decoder_out", "conv"))
    return rows


def tissue_seg_with_depth_rows(backbone_dims, backbone_depths) -> List[Row]:
    rows: List[Row] = []
    _convnext_rows(rows, "rgb_backbone", "rgb_backbone", backbone_dims, backbone_depths)
    for name in ("depth_0", "depth_1", "depth_2", "depth_3", "depth_proj", "hm_0", "hm_1"):
        _basic_conv(rows, name, name)
    rows.append(("hm_out", "hm_out", "conv"))
    _cbam_aspp_rows(rows)
    for name in ("dec_0", "dec_1"):
        _basic_conv(rows, name, name)
    rows.append(("dec_out", "dec_out", "conv"))
    return rows


def _with_batch_stats(rows: List[Row], variables: dict) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` → a state dict with the running statistics."""
    sd = from_flax(rows, variables["params"])
    for tp, fp, kind in rows:
        if kind == "bn":
            node = _node(variables["batch_stats"], fp)
            sd[f"{tp}.running_mean"] = torch.tensor(np.asarray(node["mean"], np.float32))
            sd[f"{tp}.running_var"] = torch.tensor(np.asarray(node["var"], np.float32))
    return sd


def _to_variables(rows: List[Row], state_dict) -> dict:
    stats: dict = {}
    for tp, fp, kind in rows:
        if kind == "bn":
            for t, f in (("running_mean", "mean"), ("running_var", "var")):
                _set(stats, f"{fp}/{f}", state_dict[f"{tp}.{t}"].detach().float().cpu().numpy())
    return {"params": to_flax(rows, state_dict), "batch_stats": stats}


def controlnet_from_flax(params, config: UNet2DConditionConfig,
                         conditioning_embed_channels: Tuple[int, ...]):
    return from_flax(controlnet_rows(config, conditioning_embed_channels), params)


def controlnet_to_flax(state_dict, config: UNet2DConditionConfig,
                       conditioning_embed_channels: Tuple[int, ...]):
    return to_flax(controlnet_rows(config, conditioning_embed_channels), state_dict)


def tissue_seg_net_from_flax(variables: dict, config) -> Dict[str, torch.Tensor]:
    return _with_batch_stats(tissue_seg_net_rows(config), variables)


def tissue_seg_net_to_flax(state_dict, config) -> dict:
    return _to_variables(tissue_seg_net_rows(config), state_dict)


def tissue_seg_with_depth_from_flax(variables: dict, backbone_dims: Tuple[int, ...],
                                    backbone_depths: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    return _with_batch_stats(tissue_seg_with_depth_rows(backbone_dims, backbone_depths),
                             variables)


def tissue_seg_with_depth_to_flax(state_dict, backbone_dims: Tuple[int, ...],
                                  backbone_depths: Tuple[int, ...]) -> dict:
    return _to_variables(tissue_seg_with_depth_rows(backbone_dims, backbone_depths),
                         state_dict)


def proj_from_flax(params) -> Dict[str, torch.Tensor]:
    """The text projection {"kernel": (in, out), "bias"} → nn.Linear's state dict."""
    return {"weight": torch.tensor(np.asarray(params["kernel"], np.float32).T),
            "bias": torch.tensor(np.asarray(params["bias"], np.float32))}


def proj_to_flax(state_dict) -> dict:
    return {"kernel": np.ascontiguousarray(state_dict["weight"].detach().float().cpu().numpy().T),
            "bias": state_dict["bias"].detach().float().cpu().numpy()}


# ---------------------------------------------------------------------------
# the JAX trainer's fine-tuned UNet directory
# ---------------------------------------------------------------------------

def flatten_tree(node, prefix: str = "", out=None) -> Dict[str, np.ndarray]:
    """A nested dict → {"a/b/c": array}, the npz keys of the JAX package."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k, v in node.items():
            flatten_tree(v, f"{prefix}/{k}" if prefix else k, out)
    else:
        out[prefix] = np.asarray(node)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        _set(tree, k, v)
    return tree


def load_unet_dir(path: str):
    """Read a UNet saved by the JAX package's ``save_unet_dir``. Returns
    (config, unet state dict, projection state dict or None)."""
    with open(os.path.join(path, "unet_config.json")) as f:
        cfg = json.load(f)
    for k in ("block_out_channels", "down_block_types", "up_block_types"):
        cfg[k] = tuple(cfg[k])
    config = UNet2DConditionConfig(**cfg)
    with np.load(os.path.join(path, "unet_params.npz")) as z:
        params = unflatten_tree({k: z[k] for k in z.files})
    proj: Optional[dict] = None
    proj_path = os.path.join(path, "proj_weights.npz")
    if os.path.exists(proj_path):
        with np.load(proj_path) as z:
            proj = proj_from_flax(unflatten_tree({k: z[k] for k in z.files}))
    return config, unet_from_flax(params, config), proj


def save_unet_dir(path: str, config: UNet2DConditionConfig, unet_state_dict,
                  proj_state_dict=None) -> None:
    """Write a UNet (and the text projection) in the JAX trainer's layout:
    ``unet_params.npz`` (flax tree, "/"-joined keys), ``unet_config.json``,
    ``proj_weights.npz`` (``{"kernel", "bias"}``)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "unet_params.npz"),
             **flatten_tree(unet_to_flax(unet_state_dict, config)))
    with open(os.path.join(path, "unet_config.json"), "w") as f:
        json.dump(config.__dict__, f, default=list, indent=2)
    if proj_state_dict is not None:
        np.savez(os.path.join(path, "proj_weights.npz"), **flatten_tree(proj_to_flax(proj_state_dict)))


# ---------------------------------------------------------------------------
# a diffusers SD checkpoint directory
# ---------------------------------------------------------------------------

_LEGACY_VAE_ATTN = re.compile(r"^(.*mid_block\.attentions\.0)\.(query|key|value|proj_attn)\.")
_LEGACY_VAE_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def _find_weights(subdir: str) -> str:
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin"):
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weight file in {subdir}")


def load_sd_component(model_dir: str, component: str):
    """One component (``"unet"`` | ``"vae"`` | ``"text_encoder"``) of an SD
    checkpoint directory (or ``model_dir`` is the component's own directory)
    → (config, state dict with the port's names, tensors in their stored
    dtype). Config fields and defaults as in the JAX package."""
    sub = os.path.join(model_dir, component)
    if not os.path.isdir(sub):
        sub = model_dir
    sd = load_state_dict(_find_weights(sub))
    cfg_path = os.path.join(sub, "config.json")
    cfg = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    if component == "unet":
        base = UNet2DConditionConfig()
        config = UNet2DConditionConfig(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=cfg.get("layers_per_block", 2),
            cross_attention_dim=cfg.get("cross_attention_dim", 768),
            attention_head_dim=cfg.get("attention_head_dim", 8),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            down_block_types=tuple(cfg.get("down_block_types", base.down_block_types)),
            up_block_types=tuple(cfg.get("up_block_types", base.up_block_types)))
        return config, sd
    if component == "vae":
        config = VAEConfig(
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2),
            latent_channels=cfg.get("latent_channels", 4),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215))
        renamed = {}
        for k, v in sd.items():
            m = _LEGACY_VAE_ATTN.match(k)
            if m:  # legacy query/key/value/proj_attn (diffusers < 0.18)
                k = f"{m.group(1)}.{_LEGACY_VAE_NAMES[m.group(2)]}.{k[m.end():]}"
            renamed[k] = v
        return config, renamed
    if component == "text_encoder":
        config = CLIPTextConfig(
            vocab_size=cfg.get("vocab_size", 49408),
            hidden_size=cfg.get("hidden_size", 768),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            mlp_dim=cfg.get("intermediate_size", 3072),
            max_positions=cfg.get("max_position_embeddings", 77))
        prefix = "" if any(k.startswith("text_model.") for k in sd) else "text_model."
        # transformers' position_ids buffer is arange(77): nothing to load
        return config, {prefix + k: v for k, v in sd.items()
                        if not k.endswith("embeddings.position_ids")}
    raise ValueError(f"unknown SD component {component!r}")
