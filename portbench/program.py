"""The benchmark's side of the program under test (``ldiffusion_tpu_torch``):
its SD-v1.5 components built from a configuration file and loaded with the
benchmark's seeded weights, which the reference gets too."""
from __future__ import annotations

import torch
from torch import nn

from portbench import weights
from portbench.reference import models


def reference_modules(cfg: dict, vgg: bool = False) -> dict:
    """The reference's modules on the meta device: the names and shapes of
    the weights."""
    with torch.device("meta"):
        mods = {"unet": models.UNet(cfg["unet"]), "vae": models.VAE(cfg["vae"]),
                "text": models.CLIPText(cfg["text_encoder"]),
                "proj": models.Linear(cfg["text_encoder"]["hidden_size"],
                                      cfg["unet"]["cross_attention_dim"])}
        if vgg:
            mods["vgg"] = models.VGG19Features()
    return mods


def sd_states(cfg: dict, seed: int, device, dtype, vgg: bool = False) -> dict:
    """The seeded state dicts of the SD components (and VGG19), one draw a
    module from one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, weights.WEIGHTS))
    return {k: weights.seeded_state(m, gen, device, dtype)
            for k, m in reference_modules(cfg, vgg).items()}


def program_components(cfg: dict, states: dict, device):
    """The program's ``SDComponents`` at the configuration's widths, loaded
    (strictly) with ``states``, in the states' dtype."""
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from ldiffusion_tpu_torch.models.unet import UNet2DCondition, UNet2DConditionConfig
    from ldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    u, v, t = cfg["unet"], cfg["vae"], cfg["text_encoder"]
    ucfg = UNet2DConditionConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        cross_attention_dim=u["cross_attention_dim"], attention_head_dim=u["attention_head_dim"],
        norm_num_groups=u["norm_num_groups"], down_block_types=tuple(u["down_block_types"]),
        up_block_types=tuple(u["up_block_types"]))
    vcfg = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                     latent_channels=v["latent_channels"],
                     block_out_channels=tuple(v["block_out_channels"]),
                     layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
                     scaling_factor=v["scaling_factor"])
    tcfg = CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                          num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                          mlp_dim=t["intermediate_size"], max_positions=t["max_position_embeddings"],
                          layer_norm_eps=t["layer_norm_eps"])
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(ucfg), "vae": AutoencoderKL(vcfg),
                "text": CLIPTextEncoder(tcfg), "proj": nn.Linear(t["hidden_size"],
                                                                 u["cross_attention_dim"])}
    dtype = states["unet"]["conv_in.weight"].dtype
    for key, m in mods.items():
        m.to_empty(device=device).to(dtype).load_state_dict(states[key])
        m.eval()
    comps = SDComponents(ucfg, vcfg, tcfg, mods["unet"], mods["vae"], mods["text"], mods["proj"])
    return comps.to(device=device, dtype=dtype)


def program_vgg(state: dict, device):
    """The program's frozen VGG19 features loaded with ``state``."""
    from ldiffusion_tpu_torch.models.vgg import VGG19Features

    with torch.device("meta"):
        vgg = VGG19Features()
    vgg = vgg.to_empty(device=device)
    vgg.load_state_dict(state)
    return vgg.requires_grad_(False).eval()
