"""The conductor nets (``models/conductor.py``), their losses
(``losses/dice.py``: ``micro_dice_soft``, ``CombinedLoss``,
``kl_div_multichannel``), ``resize_nearest`` and
``SDComponents.text_embeddings`` of the port against the JAX package's, on
the CPU in f32.

Both nets run at the tiny backbone (dims 8-32, one block a stage; the depth
net's fixed 64-512 branches as they are) on 64² inputs, with every
parameter and running statistic drawn non-zero from a numpy seed and
carried with ``*_from_flax``.

Tolerances: the nets' outputs and running statistics 1e-4 absolute (f32,
another summation order through a ConvNeXt, CBAM, ASPP and a decoder; the
final ×32 bilinear upsample places samples by torch's and JAX's own f32
formulas, up to 1.8e-5 apart); the losses and ``micro_dice_soft``'s
gradient 1e-5; ``resize_nearest`` exact (an index pick); the text
embeddings 1e-4 (the models' parity bound).
"""
import json
import math

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ldiffusion_tpu.diffusion.pipeline import SDComponents as JSDComponents
from ldiffusion_tpu.diffusion.pipeline import init_proj as j_init_proj
from ldiffusion_tpu.losses import dice as jdice
from ldiffusion_tpu.models import conductor as jcond
from ldiffusion_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from ldiffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from ldiffusion_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from ldiffusion_tpu.ops import resize as jresize
from ldiffusion_tpu_torch.diffusion.pipeline import DEFAULT_PROMPT, SDComponents
from ldiffusion_tpu_torch.losses import dice as tdice
from ldiffusion_tpu_torch.models import conductor as tcond
from ldiffusion_tpu_torch.models import convert
from ldiffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from ldiffusion_tpu_torch.ops import resize as tresize
from torch_port_common import JittedModule, flat, random_params
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

TOL = 1e-4
LOSS_TOL = 1e-5
DIMS, DEPTHS = (8, 16, 32, 32), (1, 1, 1, 1)
CLASSES = 4


def _variables(module, *inputs, seed):
    abstract = jax.eval_shape(lambda: module.init(jax.random.key(0), *inputs))
    return random_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), abstract),
                         np.random.default_rng(seed))


def _nets():
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    depth = rng.random((2, 64, 64, 1)).astype(np.float32)
    cfg = jcond.TissueSegNetConfig.tiny(CLASSES)
    seg_j = jcond.TissueSegNet(cfg)
    seg_v = _variables(seg_j, jnp.zeros((1, 64, 64, 3)), seed=1)
    seg_t = tcond.TissueSegNet(tcond.TissueSegNetConfig.tiny(CLASSES))
    seg_t.load_state_dict(convert.tissue_seg_net_from_flax(seg_v, seg_t.config))
    dep_j = jcond.TissueSegWithDepthHeatmap(CLASSES, DIMS, DEPTHS)
    dep_v = _variables(dep_j, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)), seed=2)
    dep_t = tcond.TissueSegWithDepthHeatmap(CLASSES, DIMS, DEPTHS)
    dep_t.load_state_dict(convert.tissue_seg_with_depth_from_flax(dep_v, DIMS, DEPTHS))
    return {"seg": (seg_j, seg_v, seg_t, (rgb,)), "depth": (dep_j, dep_v, dep_t, (rgb, depth))}


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _max_err(port: dict, ref: dict):
    assert set(port) == set(ref)
    return max(float(np.abs(_nhwc(port[k]) - np.asarray(ref[k])).max()) for k in ref)


@pytest.mark.parametrize("name", ["seg", "depth"])
def test_conductor_net_matches_jax_in_eval_mode(nets, name):
    jnet, variables, tnet, inputs = nets[name]
    ref = jax.jit(lambda v, *a: jnet.apply(v, *a))(variables, *inputs)
    with torch.no_grad():
        out = tnet.eval()(*(_nchw(x) for x in inputs))
    assert all(o.shape[2:] == (64, 64) and o.dtype == torch.float32 for o in out.values())
    assert _max_err(out, ref) <= TOL


@pytest.mark.parametrize("name", ["seg", "depth"])
def test_batchnorm_running_statistics_after_one_train_step(nets, name, monkeypatch):
    """One train-mode forward: BatchNorm normalises with the batch and folds
    it into the running statistics (flax momentum 0.9, biased variance). The
    ASPP's dropout is random in both packages, so it is off in both."""
    jnet, variables, tnet, inputs = nets[name]
    monkeypatch.setattr(fnn, "Dropout", lambda *a, **k: (lambda x: x))
    ref, updated = jax.jit(lambda v, *a: jnet.apply(v, *a, train=True,
                                                    mutable=["batch_stats"]))(variables, *inputs)
    port = tcond.TissueSegNet(tnet.config) if name == "seg" else \
        tcond.TissueSegWithDepthHeatmap(CLASSES, DIMS, DEPTHS)
    port.load_state_dict(tnet.state_dict())
    port.aspp.dropout = 0.0
    with torch.no_grad():
        out = port(*(_nchw(x) for x in inputs), train=True)
    assert _max_err(out, ref) <= TOL
    rows = (convert.tissue_seg_net_rows(tnet.config) if name == "seg"
            else convert.tissue_seg_with_depth_rows(DIMS, DEPTHS))
    got = flat(convert._to_variables(rows, port.state_dict())["batch_stats"])
    want, before = flat(updated["batch_stats"]), flat(variables["batch_stats"])
    assert set(got) == set(want)
    for k in want:
        assert not np.allclose(want[k], before[k]), k  # the statistics moved
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


def test_aspp_dropout_is_active_only_in_training():
    """In training the projection's outputs are dropped with p = 0.5 and the
    kept ones scaled by 2; in evaluation nothing is dropped."""
    aspp = tcond.ASPP(8, 16)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(aspp(x), aspp(x))
        aspp.dropout = 0.0
        full = aspp(x, train=True)
        aspp.dropout = 0.5
        torch.manual_seed(0)
        y = aspp(x, train=True)
    kept, live = y != 0, full != 0
    torch.testing.assert_close(y[kept], 2 * full[kept])
    share = float((live & ~kept).sum()) / float(live.sum())
    assert 0.3 < share < 0.7, share


@pytest.mark.parametrize("name", ["seg", "depth"])
def test_conductor_weights_round_trip_bit_exact(nets, name):
    _, variables, tnet, _ = nets[name]
    if name == "seg":
        back = convert.tissue_seg_net_to_flax(tnet.state_dict(), tnet.config)
        again = convert.tissue_seg_net_from_flax(back, tnet.config)
    else:
        back = convert.tissue_seg_with_depth_to_flax(tnet.state_dict(), DIMS, DEPTHS)
        again = convert.tissue_seg_with_depth_from_flax(back, DIMS, DEPTHS)
    want, got = flat(variables), flat(back)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    sd = tnet.state_dict()
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("name", ["seg", "depth"])
def test_full_width_conductor_structure_matches_jax(name):
    """ConvNeXt-Tiny 96-768 (3, 3, 9, 3), 7 classes: the port on
    ``device="meta"`` against ``jax.eval_shape`` of the flax init."""
    with torch.device("meta"):
        if name == "seg":
            port = tcond.TissueSegNet(tcond.TissueSegNetConfig())
            jnet, inputs = jcond.TissueSegNet(jcond.TissueSegNetConfig()), (jnp.zeros((1, 64, 64, 3)),)
            rows = convert.tissue_seg_net_rows(port.config)
        else:
            port = tcond.TissueSegWithDepthHeatmap(7)
            jnet = jcond.TissueSegWithDepthHeatmap(7)
            inputs = (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)))
            rows = convert.tissue_seg_with_depth_rows((96, 192, 384, 768), (3, 3, 9, 3))
    abstract = jax.eval_shape(lambda: jnet.init(jax.random.key(0), *inputs))
    shapes = {"/".join(k.key for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_leaves_with_path(abstract["params"])}
    assert sum(p.numel() for p in port.parameters()) == sum(math.prod(s) for s in shapes.values())
    sd = port.state_dict()
    for tp, fp, kind in rows:
        tw, fw = convert._LEAVES[kind]
        w = np.zeros(shapes[f"{fp}/{fw}"], np.float32)
        assert tuple(sd[f"{tp}.{tw}"].shape) == convert._torch_layout(kind, w).shape, fp
    assert len(rows) == len({fp for _, fp, _ in rows})


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _logits_targets():
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.normal(size=(2, 6, 16, 16))).astype(np.float32)  # NCHW
    targets = rng.integers(0, 5, (2, 16, 16))  # class 5 absent
    targets[0, :3] = 255  # the ignore label
    return logits, targets


@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 2.0, 1.0), (1.0, 2.0, 2.0, 1.0, 3.0, 0.5, 9.0)])
def test_micro_dice_soft_and_its_gradient_match_jax(weights):
    logits, targets = _logits_targets()
    jlog = jnp.asarray(logits.transpose(0, 2, 3, 1))
    want = jdice.micro_dice_soft(jlog, jnp.asarray(targets), 6, weights)
    jgrad = np.asarray(jax.grad(lambda lg: jdice.micro_dice_soft(lg, jnp.asarray(targets), 6,
                                                                  weights))(jlog))
    tlog = torch.from_numpy(logits).requires_grad_()
    got = tdice.micro_dice_soft(tlog, torch.from_numpy(targets), 6, weights)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    np.testing.assert_allclose(tlog.grad.permute(0, 2, 3, 1).numpy(), jgrad, atol=LOSS_TOL,
                               rtol=0)
    assert float(np.abs(jgrad).max()) > 1e-4


def test_combined_loss_and_kl_match_jax():
    logits, targets = _logits_targets()
    jlog = jnp.asarray(logits.transpose(0, 2, 3, 1))
    for num_classes in (6, 7):  # 7: one more class than the logits have channels
        if num_classes == 7:
            logits7 = np.concatenate([logits, logits[:, :1] - 3.0], axis=1)
            jlog, tlog = jnp.asarray(logits7.transpose(0, 2, 3, 1)), torch.from_numpy(logits7)
        else:
            tlog = torch.from_numpy(logits)
        want = jdice.CombinedLoss(num_classes)(jlog, jnp.asarray(targets))
        got = tdice.CombinedLoss(num_classes)(tlog, torch.from_numpy(targets))
        assert abs(float(got) - float(want)) <= LOSS_TOL
    other = np.random.default_rng(4).normal(size=logits.shape).astype(np.float32)
    want = jdice.kl_div_multichannel(jnp.asarray(logits), jnp.asarray(other))  # both on axis 1
    got = tdice.kl_div_multichannel(torch.from_numpy(logits), torch.from_numpy(other))
    assert abs(float(got) - float(want)) <= LOSS_TOL * max(1.0, abs(float(want)))
    assert float(tdice.kl_div_multichannel(torch.from_numpy(logits), torch.from_numpy(logits))) \
        == pytest.approx(0.0, abs=1e-5)


# ---------------------------------------------------------------------------
# resize_nearest and the text embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((7, 9), (10, 13)), ((10, 13), (7, 9)), ((5, 6), (13, 4)),
                                     ((64, 64), (48, 80)), ((3, 3), (3, 8))])
@pytest.mark.parametrize("channel_last", [True, False])
def test_resize_nearest_matches_jax_at_non_integer_ratios(src, dst, channel_last):
    shape = (2,) + (src + (3,) if channel_last else (3,) + src)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), dst, channel_last))
    got = tresize.resize_nearest(torch.from_numpy(x), dst, channel_last).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    if src == (7, 9) and channel_last:  # torch's floor convention picks other pixels here
        naive = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
        assert not np.array_equal(naive.permute(0, 2, 3, 1).numpy(), want)


def _tokenizer_dir(root):
    vocab = {"<|startoftext|>": 49406, "<|endoftext|>": 49407, "a</w>": 320,
             "pathological</w>": 29018, "slide</w>": 10556}
    merges = []
    for word in ("pathological", "slide"):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        cur = parts[0]
        for nxt in parts[1:]:
            merges.append(f"{cur} {nxt}")
            cur += nxt
            vocab.setdefault(cur, 1000 + len(vocab))
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(root)


def test_text_embeddings_match_jax(tmp_path):
    import dataclasses

    tcfg = dataclasses.replace(JCLIPConfig.tiny(), vocab_size=49408)
    jtext = JCLIP(tcfg)
    k1, k2 = jax.random.split(jax.random.key(0))
    params = {"text": jax.jit(jtext.init)(k1, jnp.zeros((1, 5), jnp.int32))["params"],
              "proj": j_init_proj(k2, tcfg.hidden_size, 32)}
    jc = JSDComponents(unet_config=None, vae_config=None, text_config=tcfg, unet=None, vae=None,
                       text=JittedModule(jtext), params=params)
    comps = SDComponents.random(device="cpu")
    comps.text.load_state_dict(convert.clip_text_from_flax(params["text"], tcfg.num_layers))
    comps.proj.load_state_dict(convert.proj_from_flax(params["proj"]))
    with torch.no_grad():
        for prompt in (None, DEFAULT_PROMPT):
            got = comps.text_embeddings(3, prompt).numpy()
            want = np.asarray(jc.text_embeddings(batch_size=3, prompt=prompt))
            assert got.shape == want.shape == (3, 5, 32)
            assert float(np.abs(got - want).max()) <= TOL
        with pytest.raises(ValueError, match="tokenizer"):
            comps.text_embeddings(1, "a slide")
        tok = _tokenizer_dir(tmp_path)
        comps.tokenizer = CLIPTokenizer.from_pretrained(tok)
        jc.tokenizer = JTokenizer.from_pretrained(tok)
        got = comps.text_embeddings(2, "a slide").numpy()
        want = np.asarray(jc.text_embeddings(batch_size=2, prompt="a slide"))
    assert got.shape == want.shape == (2, 4, 32) and float(np.abs(got - want).max()) <= TOL
