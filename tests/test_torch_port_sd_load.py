"""Reading a diffusers SD checkpoint directory: the port's safetensors reader,
CLIP tokenizer, ``load_sd_component`` and ``SDComponents.load`` against the
JAX package's, on a tiny directory this file writes itself (its own
safetensors writer, ``config.json`` files, a toy vocab/merges covering the
prompts below). The VAE carries the legacy attention names and is a ``.bin``
file; the CLIP state dict carries transformers' ``position_ids`` buffer.

Tolerances: token ids, state dicts and the reader are exact. The one-step
transform of the two loaded bundles, f32, runs the same tiny stack in another
summation order: ≤ 1e-5 (such a stack reads 1.7e-6 on the CPU). Both loads
take the same override directory, so they share the text projection (the
JAX package draws its own from ``jax.random.key(0)``, which torch cannot).
"""
import json
import os
import struct

import numpy as np
import pytest
import safetensors.torch
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
from ldiffusion_tpu_torch.models.convert import load_sd_component, save_unet_dir
from ldiffusion_tpu_torch.models.safetensors_io import load_safetensors
from ldiffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

TRANSFORM_TOL = 1e-5
PROMPTS = ("A pathological slide", "  a PATHOLOGICAL\tslide  ", "a slide, of tissue!",
           "pathological tissue slide of a slide", "A pathological slide's tissue")
# the real CLIP ids of the fixed prompt's words (pipeline.DEFAULT_PROMPT_IDS)
CLIP_IDS = {"<|startoftext|>": 49406, "<|endoftext|>": 49407, "a</w>": 320,
            "pathological</w>": 29018, "slide</w>": 10556}
_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
              torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
              torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def write_safetensors(path, tensors):
    """The format: u64 header length, a JSON header padded to 8 bytes, raw
    little-endian bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def write_toy_tokenizer(root, prompts):
    """vocab.json + merges.txt: every character of ``prompts`` (and each with
    ``</w>``), and left-to-right merges building each of their words."""
    vocab, merges = dict(CLIP_IDS), []
    words = set()
    for p in prompts:
        words.update(p.lower().replace(",", " , ").replace("!", " ! ")
                     .replace("'s", " 's").split())
    pieces = set()
    for w in sorted(words):
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        pieces.update(parts)
        cur = parts[0]
        for nxt in parts[1:]:
            merges.append(f"{cur} {nxt}")
            cur += nxt
            pieces.add(cur)
    for c in {c for p in prompts for c in p.lower() if not c.isspace()}:
        pieces.update((c, c + "</w>"))
    next_id = 1000
    for piece in sorted(pieces):
        if piece not in vocab:
            vocab[piece] = next_id
            next_id += 1
    os.makedirs(root)
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def _write_config(sub, cfg):
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(cfg, f)


def write_sd_dir(root, comps):
    """A diffusers-layout directory of ``comps`` (the port's modules)."""
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(os.path.join(root, sub))
    u, v, t = comps.unet_config, comps.vae_config, comps.text_config
    _write_config(os.path.join(root, "unet"), {
        "in_channels": u.in_channels, "out_channels": u.out_channels,
        "block_out_channels": list(u.block_out_channels),
        "layers_per_block": u.layers_per_block, "cross_attention_dim": u.cross_attention_dim,
        "attention_head_dim": u.attention_head_dim, "norm_num_groups": u.norm_num_groups,
        "down_block_types": list(u.down_block_types), "up_block_types": list(u.up_block_types)})
    write_safetensors(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"),
                      comps.unet.state_dict())
    _write_config(os.path.join(root, "vae"), {
        "block_out_channels": list(v.block_out_channels), "layers_per_block": v.layers_per_block,
        "latent_channels": v.latent_channels, "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor})
    legacy = {}
    for k, w in comps.vae.state_dict().items():
        for new, old in _LEGACY.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        legacy[k] = w.clone()
    torch.save(legacy, os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    _write_config(os.path.join(root, "text_encoder"), {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
        "intermediate_size": t.mlp_dim, "max_position_embeddings": t.max_positions})
    text_sd = dict(comps.text.state_dict())
    text_sd["text_model.embeddings.position_ids"] = torch.arange(t.max_positions)[None]
    write_safetensors(os.path.join(root, "text_encoder", "model.safetensors"), text_sd)
    write_toy_tokenizer(os.path.join(root, "tokenizer"), PROMPTS)


@pytest.fixture(scope="module")
def sd_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    comps = tpipe.SDComponents.random(seed=3, device="cpu")
    model_dir, override = str(root / "sd15"), str(root / "override")
    write_sd_dir(model_dir, comps)
    save_unet_dir(override, comps.unet_config, comps.unet.state_dict(), comps.proj.state_dict())
    return {"comps": comps, "dir": model_dir, "override": override}


def test_safetensors_reader_matches_the_library(tmp_path):
    """Every dtype bit for bit (bf16 stays bf16), against the safetensors
    package reading the same file this file's writer wrote."""
    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
               "f16": torch.randn(7, generator=g).half(), "f32": torch.randn(2, 2, 2, generator=g),
               "f64": torch.randn(3, generator=g).double(), "i64": torch.arange(5)[None],
               "i32": torch.arange(-3, 3, dtype=torch.int32), "u8": torch.arange(9, dtype=torch.uint8),
               "bool": torch.tensor([True, False, True]), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, tensors)
    ours, lib = load_safetensors(path), safetensors.torch.load_file(path)
    assert set(ours) == set(lib) == set(tensors)
    for k, t in tensors.items():
        assert ours[k].dtype == lib[k].dtype == t.dtype and ours[k].shape == t.shape, k
        assert torch.equal(ours[k], lib[k]) and torch.equal(ours[k], t), k


@pytest.mark.parametrize("padding", [False, True])
def test_token_ids_match_jax(sd_world, padding):
    tok_dir = os.path.join(sd_world["dir"], "tokenizer")
    ours, ref = CLIPTokenizer.from_pretrained(sd_world["dir"]), JTokenizer.from_pretrained(tok_dir)
    for prompt in PROMPTS:
        ids = ours([prompt], padding=padding)["input_ids"]
        assert ids == ref([prompt], padding=padding)["input_ids"], prompt
        assert len(ids[0]) == 77 if padding else ids[0][-1] == 49407
    assert tuple(ours([PROMPTS[0]])["input_ids"][0]) == tpipe.DEFAULT_PROMPT_IDS
    with pytest.raises(FileNotFoundError):
        CLIPTokenizer.from_pretrained(os.path.join(sd_world["dir"], "unet"))


def test_components_read_back_exactly(sd_world):
    """Each component's state dict as written: the legacy VAE names renamed,
    ``position_ids`` dropped; a component directory may be given directly."""
    comps = sd_world["comps"]
    for name, module in (("unet", comps.unet), ("vae", comps.vae), ("text_encoder", comps.text)):
        cfg, sd = load_sd_component(sd_world["dir"], name)
        want = module.state_dict()
        assert set(sd) == set(want), name
        for k in want:
            assert torch.equal(sd[k], want[k]), k
    assert load_sd_component(sd_world["dir"], "unet")[0] == comps.unet_config
    assert load_sd_component(sd_world["dir"], "vae")[0] == comps.vae_config
    assert load_sd_component(sd_world["dir"], "text_encoder")[0] == comps.text_config
    direct_cfg, _ = load_sd_component(os.path.join(sd_world["dir"], "vae"), "vae")
    assert direct_cfg == comps.vae_config


def test_sd_load_matches_jax_one_step_transform(sd_world):
    jc = jpipe.SDComponents.load(sd_world["dir"], dtype=jnp.float32,
                                 unet_override_dir=sd_world["override"])
    comps = tpipe.SDComponents.load(sd_world["dir"], dtype=torch.float32, device="cpu",
                                    unet_override_dir=sd_world["override"])
    assert comps.prompt_ids == tuple(jc.prompt_ids) == tpipe.DEFAULT_PROMPT_IDS
    img = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jemb = jpipe.trajectory_text_emb(jc, jc.params, 1)
    ref = np.asarray(jax.jit(lambda p, x: jpipe.one_step_transform(jc, p, x, jemb))(
        jc.params, jnp.asarray(img)))
    with torch.inference_mode():
        out = tpipe.one_step_transform(comps, torch.from_numpy(img),
                                       tpipe.trajectory_text_emb(comps, 1)).numpy()
    err = float(np.max(np.abs(out - ref)))
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert err <= TRANSFORM_TOL, err


def test_missing_or_unknown_key_raises(sd_world, tmp_path):
    for edit in ("drop", "add"):
        broken = str(tmp_path / edit)
        os.makedirs(broken)
        for sub in ("vae", "text_encoder", "tokenizer"):
            os.symlink(os.path.join(sd_world["dir"], sub), os.path.join(broken, sub))
        os.makedirs(os.path.join(broken, "unet"))
        src = os.path.join(sd_world["dir"], "unet")
        os.symlink(os.path.join(src, "config.json"), os.path.join(broken, "unet", "config.json"))
        sd = dict(sd_world["comps"].unet.state_dict())
        if edit == "drop":
            sd.pop("conv_in.bias")
        else:
            sd["conv_in.extra"] = torch.zeros(1)
        write_safetensors(os.path.join(broken, "unet", "diffusion_pytorch_model.safetensors"), sd)
        with pytest.raises(RuntimeError, match="conv_in"):
            tpipe.SDComponents.load(broken, dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError):
        tpipe.SDComponents.load(str(tmp_path / "nothing"), device="cpu")


def test_api_loads_the_directory_in_bf16(sd_world):
    """Without ``components=`` a non-``random:`` path is read as a directory,
    in bf16; with ``components=`` the path is not read."""
    comps = LDiffusionModel(sd_world["dir"], "cell", device="cpu")._load_components()
    assert comps.unet.conv_in.weight.dtype == torch.bfloat16
    assert comps.text.text_model.final_layer_norm.weight.dtype == torch.bfloat16
    want = sd_world["comps"].vae.state_dict()
    for k, v in comps.vae.state_dict().items():
        assert torch.equal(v, want[k].bfloat16()), k
    given = tpipe.SDComponents.random(seed=1, device="cpu")
    model = LDiffusionModel("no/such/directory", "cell", components=given, device="cpu")
    assert model._load_components() is given
