"""Plain PyTorch models of the benchmark's reference: SD-v1.5's UNet, VAE
and CLIP text tower, the text projection, VGG19's features and the 2D
nnU-Net DynUNet.

They carry the published architectures' (diffusers', transformers',
torchvision's, nnU-Net's) state-dict names, so one seeded state dict loads
into them and into the program under test. Everything is NCHW float32 with
no fused kernel: GroupNorm is ``F.group_norm``, attention is softmax over
explicit logits, computed in blocks of queries so that 16384-token
attention fits. Quirks of L-Diffusion that the program keeps are kept here
too: GroupNorm eps 1e-6 in the transformer and the VAE, exact-erf GEGLU,
the ``[cos | sin]`` timestep embedding, the VAE downsample's (0, 1) padding.

``Precision`` says how it computes: float32 (TF32 is switched off by
``reference_math``), or, for the control, in float8 (its docstring).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

QUERY_BLOCK = 1024  # queries per block of attention logits


class Precision:
    """The precision of the reference's arithmetic. ``fp8`` False is
    float32. ``fp8`` True is the control's float8: every product's operands
    rounded to e4m3 in the forward and the gradients reaching them to e5m2
    in the backward (one scale a tensor: FP8 training's recipe)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x):
        return _Fp8Round.apply(x) if self.fp8 else x


def _round(x, dtype, top: float):
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(dtype).float().div(scale).to(x.dtype)


class _Fp8Round(torch.autograd.Function):
    """x rounded to float8 e4m3 under one scale (448 / max |x|); its
    gradient rounded to e5m2 (57344 / max |g|)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


@contextlib.contextmanager
def reference_math():
    """float32 products without TF32 on the card, restored on exit."""
    kept = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept


class Conv(nn.Conv2d):
    prec = Precision()

    def forward(self, x):
        return self._conv_forward(self.prec(x), self.prec(self.weight), self.bias)


class Linear(nn.Linear):
    prec = Precision()

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class ConvTranspose(nn.ConvTranspose2d):
    prec = Precision()

    def forward(self, x):
        return F.conv_transpose2d(self.prec(x), self.prec(self.weight), self.bias, self.stride)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    """Give every layer of ``model`` that computes ``prec``."""
    for m in model.modules():
        if hasattr(m, "prec"):
            m.prec = prec
    return model


_RECORDERS: list = []  # the open ``recording()``s


@contextlib.contextmanager
def recording():
    """Within it every attention call's (B, Sq, Sk, H, D) and every
    GroupNorm's input shape are listed: the operation counts read them."""
    calls = {"attention": [], "groupnorm": []}
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def attention(q, k, v, prec: Precision):
    """(B, S, H, D) softmax(q kᵀ / sqrt(D)) v in float32, in blocks of queries."""
    b, sq, h, d = q.shape
    for calls in _RECORDERS:
        calls["attention"].append((b, sq, k.shape[1], h, d))
    q, k, v = prec(q), prec(k), prec(v)
    out = []
    for s in range(0, sq, QUERY_BLOCK):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:s + QUERY_BLOCK], k) / math.sqrt(d)
        probs = prec(torch.softmax(logits, dim=-1))
        out.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    return torch.cat(out, dim=1)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5, silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        for calls in _RECORDERS:
            calls["groupnorm"].append(tuple(x.shape))
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float = 1e-5, groups: int = 32,
                 temb: int = None):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(cout, groups, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return h + (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x)


class Downsample(nn.Module):
    def __init__(self, ch: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv(ch, ch, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric_pad else x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int = None,
                 bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(dim, inner, bias=bias)
        self.to_k = Linear(context_dim or dim, inner, bias=bias)
        self.to_v = Linear(context_dim or dim, inner, bias=bias)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        out = attention(q, k, v, self.to_q.prec)
        return self.to_out[0](out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, head_dim: int, context_dim: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(ch, groups, 1e-6, silu=False)
        self.proj_in = Conv(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, head_dim, context_dim)])
        self.proj_out = Conv(ch, ch, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context)
        return self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2)) + res


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(ch, groups, 1e-6, silu=False)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (f(y)[:, :, None, :] for f in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](attention(q, k, v, self.to_q.prec).reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _Block(nn.Module):
    pass


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel as SD v1.5 configures it; ``cfg`` the
    configuration file's ``unet`` group (``attention_head_dim`` is the number
    of heads)."""

    def __init__(self, cfg: dict):
        super().__init__()
        chans = cfg["block_out_channels"]
        ch0, heads, g = chans[0], cfg["attention_head_dim"], cfg["norm_num_groups"]
        ctx, tdim, lpb = cfg["cross_attention_dim"], chans[0] * 4, cfg["layers_per_block"]
        self.conv_in = Conv(cfg["in_channels"], ch0, 3, padding=1)
        self.time_embedding = TimeEmbedding(ch0, tdim)
        self.down_blocks = nn.ModuleList()
        skips, cin = [ch0], ch0
        for i, (kind, ch) in enumerate(zip(cfg["down_block_types"], chans)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if kind == "CrossAttnDownBlock2D":
                blk.attentions = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(ResnetBlock(cin, ch, groups=g, temb=tdim))
                if kind == "CrossAttnDownBlock2D":
                    blk.attentions.append(Transformer2D(ch, heads, ch // heads, ctx, g))
                cin = ch
                skips.append(ch)
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch)])
                skips.append(ch)
            self.down_blocks.append(blk)
        mid = chans[-1]
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(mid, mid, groups=g, temb=tdim) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2D(mid, heads, mid // heads, ctx, g)])
        self.up_blocks = nn.ModuleList()
        h_ch = mid
        for i, (kind, ch) in enumerate(zip(cfg["up_block_types"], reversed(chans))):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if kind == "CrossAttnUpBlock2D":
                blk.attentions = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(ResnetBlock(h_ch + skips.pop(), ch, groups=g, temb=tdim))
                if kind == "CrossAttnUpBlock2D":
                    blk.attentions.append(Transformer2D(ch, heads, ch // heads, ctx, g))
                h_ch = ch
            if i < len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(ch0, g, 1e-5)
        self.conv_out = Conv(ch0, cfg["out_channels"], 3, padding=1)

    def forward(self, x, t: int, ctx):
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        temb = self.time_embedding(timestep_embedding(tt, self.conv_in.out_channels))
        h = self.conv_in(x)
        res = [h]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                res.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                res.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, res.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


def _vae_mid(ch: int, g: int) -> nn.Module:
    mid = _Block()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, 1e-6, g) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ch, g)])
    return mid


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans, g, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["in_channels"], chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(ResnetBlock(cin, ch, 1e-6, g))
                cin = ch
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, asymmetric_pad=True)])
            self.down_blocks.append(blk)
        self.mid_block = _vae_mid(chans[-1], g)
        self.conv_norm_out = GroupNorm(chans[-1], g, 1e-6)
        self.conv_out = Conv(chans[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        return self.conv_out(self.conv_norm_out(_run_mid(self.mid_block, h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans, g, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        rev = list(reversed(chans))
        self.conv_in = Conv(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _vae_mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(ResnetBlock(cin, ch, 1e-6, g))
                cin = ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(chans[0], g, 1e-6)
        self.conv_out = Conv(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class VAE(nn.Module):
    """diffusers' AutoencoderKL; ``decode`` is the raw decode, ``decode_latents``
    unscales by ``scaling_factor`` and maps to [0, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lat = cfg["latent_channels"]
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)

    def encode_mean(self, x):
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def decode_latents(self, z):
        return (self.decode(z / self.scaling_factor) / 2.0 + 0.5).clamp(0.0, 1.0)


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int, eps: float):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Linear(d, d))
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Linear(d, mlp), Linear(mlp, d)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x):
        b, s, d = x.shape
        a, hd = self.self_attn, d // self.heads
        y = self.layer_norm1(x)
        q, k, v = (p(y).view(b, s, self.heads, hd) for p in (a.q_proj, a.k_proj, a.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(torch.where(mask, logits, torch.full_like(logits, -1e9)), dim=-1)
        x = x + a.out_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """transformers' CLIPTextModel (causal mask, quick-GELU), last hidden state."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(d, cfg["num_attention_heads"], cfg["intermediate_size"], eps)
             for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, ids):
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)


VGG19_LAYERS = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG19Features(nn.Module):
    """torchvision's ``vgg19().features`` (configuration E, through pool5)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG19_LAYERS:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


class InstanceNorm(nn.Module):
    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self.eps)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = Conv(cin, cout, 3, stride=stride, padding=1)
        self.norm = InstanceNorm(cout)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), 0.01)


class DynUNet(nn.Module):
    """nnU-Net's 2D PlainConvUNet: per stage [conv3x3 → InstanceNorm →
    LeakyReLU(0.01)] × n, strided-conv downsampling, transpose-conv
    upsampling with skip concatenation, 1x1 heads at every decoder stage (the
    full-resolution one, ``seg_0``, at inference). ``plan``: the
    configuration file's ``plan`` group."""

    def __init__(self, plan: dict):
        super().__init__()
        feats, strides, n = plan["features_per_stage"], plan["strides"], plan["n_conv_per_stage"]
        self.n_stages, self.n_conv = len(feats), n
        cin = plan["in_channels"]
        for s, f in enumerate(feats):
            for c in range(n):
                self.add_module(f"enc_{s}_{c}", ConvBlock(cin, f, strides[s] if c == 0 else 1))
                cin = f
        for d in range(len(feats) - 2, -1, -1):
            f, st = feats[d], strides[d + 1]
            self.add_module(f"up_{d}", ConvTranspose(cin, f, st, stride=st))
            cin = 2 * f
            for c in range(n):
                self.add_module(f"dec_{d}_{c}", ConvBlock(cin, f, 1))
                cin = f
            self.add_module(f"seg_{d}", Conv(f, plan["num_classes"], 1))

    def forward(self, x):
        skips = []
        for s in range(self.n_stages):
            for c in range(self.n_conv):
                x = getattr(self, f"enc_{s}_{c}")(x)
            skips.append(x)
        for d in range(self.n_stages - 2, -1, -1):
            x = torch.cat([getattr(self, f"up_{d}")(x), skips[d]], dim=1)
            for c in range(self.n_conv):
                x = getattr(self, f"dec_{d}_{c}")(x)
        return self.seg_0(x)
