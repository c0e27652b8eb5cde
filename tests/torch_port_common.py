"""Shared set-up of the ``test_torch_port_*`` files (not a test module)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu.diffusion.pipeline import SDComponents, init_proj
from ldiffusion_tpu.losses import infonce as jinfo
from ldiffusion_tpu.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ldiffusion_tpu.models.unet import UNet2DCondition, UNet2DConditionConfig
from ldiffusion_tpu.models.vae import AutoencoderKL, VAEConfig


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for torch's CPU ops in a module that imports this
    fixture: the suite runs six workers on one host, and a worker on every
    core oversubscribes it (six port files at once took 2.3 times as long);
    the previous count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_random_components() -> SDComponents:
    """What ``SDComponents.random(image_size=64)`` builds — the same configs,
    keys and initialisers — with each flax init jitted (one compile each
    instead of op-by-op dispatch, several times faster on the CPU)."""
    ucfg, vcfg = UNet2DConditionConfig.tiny(), VAEConfig.tiny()
    tcfg = dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=49408)
    unet, vae, text = UNet2DCondition(ucfg), AutoencoderKL(vcfg), CLIPTextEncoder(tcfg)
    r1, r2, r3, r4 = jax.random.split(jax.random.key(0), 4)
    params = {
        "unet": jax.jit(unet.init)(r1, jnp.zeros((1, 8, 8, 4)), jnp.int32(1),
                                   jnp.zeros((1, 5, 32)))["params"],
        "vae": jax.jit(vae.init)(r2, jnp.zeros((1, 64, 64, 3)))["params"],
        "text": jax.jit(text.init)(r3, jnp.zeros((1, 5), jnp.int32))["params"],
        "proj": init_proj(r4, tcfg.hidden_size, ucfg.cross_attention_dim),
    }
    return SDComponents(unet_config=ucfg, vae_config=vcfg, text_config=tcfg, unet=unet,
                        vae=vae, text=text, params=params)


def jax_components_of(components) -> SDComponents:
    """The JAX package's components at the port's ``components``' configs
    holding their weights (carried with ``*_to_flax``): no flax init to
    compile, and the same weights on both sides by construction."""
    from ldiffusion_tpu_torch.models import convert

    ucfg = UNet2DConditionConfig(**dataclasses.asdict(components.unet_config))
    vcfg = VAEConfig(**dataclasses.asdict(components.vae_config))
    tcfg = CLIPTextConfig(**dataclasses.asdict(components.text_config))
    params = {
        "unet": convert.unet_to_flax(components.unet.state_dict(), components.unet_config),
        "vae": convert.vae_to_flax(components.vae.state_dict(), components.vae_config),
        "text": convert.clip_text_to_flax(components.text.state_dict(), tcfg.num_layers),
        "proj": convert.proj_to_flax(components.proj.state_dict()),
    }
    return SDComponents(unet_config=ucfg, vae_config=vcfg, text_config=tcfg,
                        unet=UNet2DCondition(ucfg), vae=AutoencoderKL(vcfg),
                        text=CLIPTextEncoder(tcfg), params=params)


class JittedModule:
    """A flax module whose ``apply`` (each ``method``) is jitted: the JAX
    tools call ``module.apply`` op by op, which is several times slower on the
    CPU than one compile."""

    def __init__(self, module):
        self.module, self.compiled = module, {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, variables, *args, method=None, **kwargs):
        name = getattr(method, "__name__", "__call__")
        if name not in self.compiled:
            m = self.module
            self.compiled[name] = jax.jit(
                lambda v, *a, **k: m.apply(v, *a, method=getattr(m, name), **k))
        return self.compiled[name](variables, *args, **kwargs)


def jitted(components: SDComponents) -> SDComponents:
    """The same components (configs, params, scheduler) with jitted modules."""
    return dataclasses.replace(components, unet=JittedModule(components.unet),
                               vae=JittedModule(components.vae),
                               text=JittedModule(components.text))


def jax_contrast_indices(labels, key, num_negatives, num_anchors, num_classes):
    """The anchors, positives, negatives and validity ``contrastive_loss`` of
    the JAX package draws from ``key`` (the same splits and formulas,
    ldiffusion_tpu/losses/infonce.py:60-90), as numpy."""
    b = labels.shape[0]
    labs = jnp.asarray(labels).reshape(b, -1)
    n = labs.shape[1]
    out = []
    for lab, k in zip(labs, jax.random.split(key, b)):
        k_anchor, k_pos, k_neg, k_cls = jax.random.split(k, 4)
        if num_classes is None:
            anchor = jax.random.randint(k_anchor, (num_anchors,), 0, n)
            present = jnp.ones((num_anchors,), bool)
        else:
            class_mask = lab[None, :] == jnp.arange(num_classes)[:, None]
            scores = jnp.where(class_mask, jinfo._gumbel(k_cls, (num_classes, n)), -jnp.inf)
            uniform = jax.random.randint(k_anchor, (num_anchors - num_classes,), 0, n)
            anchor = jnp.concatenate([jnp.argmax(scores, axis=1), uniform])
            present = jnp.concatenate([class_mask.any(axis=1),
                                       jnp.ones((num_anchors - num_classes,), bool)])
        same = lab[None, :] == lab[anchor][:, None]
        n_same = jnp.sum(same, axis=1)
        valid = present & (n_same > 1) & (n - n_same > num_negatives)
        pos_mask = same.at[jnp.arange(num_anchors), anchor].set(False)
        pos = jnp.argmax(jnp.where(pos_mask, jinfo._gumbel(k_pos, (num_anchors, n)), -jnp.inf),
                         axis=1)
        neg = jax.random.categorical(k_neg, jnp.where(~same, 0.0, -jnp.inf)[:, None, :],
                                     axis=-1, shape=(num_anchors, num_negatives))
        out.append([np.asarray(a) for a in (anchor, pos, neg, valid)])
    return [np.stack(x) for x in zip(*out)]


def jax_laplace_noise(key, n_steps: int, shape):
    """The unit Laplace draws ``trajectory_features`` of the JAX package takes
    from ``key``, one per timestep (``split(key, T)``, pipeline.py:203-217),
    stacked: (T, *shape) numpy."""
    return np.stack([np.asarray(jax.random.laplace(k, shape, jnp.float32))
                     for k in jax.random.split(key, n_steps)])


def random_params(tree, rng):
    """A flax tree of the same shapes, every leaf drawn non-zero from ``rng``:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), running variances in
    [0.5, 1.5), the rest (biases, running means, ConvNeXt gammas) N(0, 0.1²).
    A fresh flax init zeroes biases, the ControlNet's zero convolutions and
    ``cond_out``, and sets gammas to 1e-6, which would hide what they feed."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng)
            continue
        if k == "kernel":
            w = rng.normal(size=v.shape) / math.sqrt(math.prod(v.shape[:-1]))
        elif k == "scale":
            w = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif k == "var":
            w = 0.5 + rng.random(v.shape)
        else:
            w = 0.1 * rng.normal(size=v.shape)
        out[k] = np.asarray(w, np.float32)
    return out


def flat(tree, prefix="", out=None):
    """A nested dict of arrays → {"a/b/c": numpy array}."""
    out = {} if out is None else out
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat(v, name, out)
        else:
            out[name] = np.asarray(v)
    return out


# The VAE of tests/test_quant_task_ab.py: its 256-channel stage passes the
# int8 shape gate (the tiny VAE's 32/64 channels never do).
GATED_VAE = dict(block_out_channels=(64, 256), layers_per_block=1, norm_num_groups=32)
GATED_VAE_SITES = 14  # its (256, 256) convs: encoder 5, decoder 9


def quant_transform_world(modes, calibrate: bool = False) -> dict:
    """The one-step transform at the tiny UNet with the GATED_VAE, the same
    weights and 64² image in both packages (f32), under each of ``modes``:
    ``{"out": {mode: (jax, port)}}`` as numpy. With ``calibrate``, also both
    packages' ``calibrate_static_scales`` (``"jscales"``, ``"tscales"``);
    ``"int8_static"`` then runs on the JAX package's scales in both."""
    import torch

    from ldiffusion_tpu.diffusion import pipeline as jpipe
    from ldiffusion_tpu.ops import quant as jq
    from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
    from ldiffusion_tpu_torch.models.vae import VAEConfig as TVAEConfig
    from ldiffusion_tpu_torch.ops import quant as tq

    comps = tpipe.SDComponents.random(seed=3, device="cpu", vae_config=TVAEConfig(**GATED_VAE))
    jc = jax_components_of(comps)
    img = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():  # the embedding's parity is test_torch_port_pipeline's
        emb = tpipe.trajectory_text_emb(comps, 1)
    jemb = jnp.asarray(emb.numpy())

    def jax_fn(params, x):
        return jpipe.one_step_transform(jc, params, x, jemb)

    def port_fn(x):
        return tpipe.one_step_transform(comps, x, emb)

    world = {"out": {}}
    if calibrate:
        world["jscales"] = jq.calibrate_static_scales(lambda x: jax_fn(jc.params, x),
                                                      jnp.asarray(img))
        world["tscales"] = tq.calibrate_static_scales(port_fn, torch.from_numpy(img))
    try:
        for mode in modes:
            for m in (jq, tq):
                m.set_quant_mode(mode)
                m.set_static_amax(world.get("jscales"))
            # a fresh function per mode: jax.jit caches by function, and the
            # mode changes the traced program
            ref = jax.jit(lambda p, x: jax_fn(p, x))(jc.params, jnp.asarray(img))
            with torch.no_grad():
                got = port_fn(torch.from_numpy(img))
            world["out"][mode] = (np.asarray(ref), got.numpy())
    finally:
        for m in (jq, tq):
            m.set_quant_mode("none")
            m.set_static_amax(None)
    return world


# ---------------------------------------------------------------------------
# multi-process runs of the port (tests/torch_port_dist_worker.py)
# ---------------------------------------------------------------------------

DIST_WORKER = __file__.replace("torch_port_common.py", "torch_port_dist_worker.py")


def spawn_ranks(task: str, world: int, root, *args):
    """Start ``world`` gloo ranks of ``task`` on ``root``; they run while the
    caller works, and wait for ``write_inputs``. Each rank is a fresh
    interpreter that imports only torch and the port."""
    import os
    import subprocess
    import sys

    os.makedirs(str(root), exist_ok=True)
    for name in ["init", "inputs.npz"] + [f"out_{r}.npz" for r in range(world)]:
        # a stale rendezvous file hangs the ranks
        if os.path.exists(os.path.join(str(root), name)):
            os.remove(os.path.join(str(root), name))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    return [subprocess.Popen([sys.executable, DIST_WORKER, task, str(r), str(world), str(root),
                              *map(str, args)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def write_inputs(root, **arrays):
    """The ranks' ``inputs.npz``, renamed into place whole."""
    import os

    tmp = os.path.join(str(root), "inputs.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(str(root), "inputs.npz"))


def rank_outputs(procs, root, timeout: float = 300.0) -> list:
    """Wait for the ranks; each one's ``out_<rank>.npz`` as a dict (raises
    with a rank's output when it failed)."""
    import os

    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=timeout)
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    results = []
    for r in range(len(procs)):
        with np.load(os.path.join(str(root), f"out_{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


def vgg_to_flax(vgg) -> dict:
    """The port's VGG19Features state as the JAX package's parameter tree
    (the inverse of ``vgg_from_flax``)."""
    from ldiffusion_tpu_torch.models.vgg import _conv_layer_ids

    sd = vgg.state_dict()
    return {f"conv_{i}": {"kernel": sd[f"features.{lid}.weight"].numpy().transpose(2, 3, 1, 0),
                          "bias": sd[f"features.{lid}.bias"].numpy()}
            for i, lid in enumerate(_conv_layer_ids())}


STAGE1 = dict(anchors=8, negatives=16, classes=4, steps=5, remat=True)


def stage1_world(root, meshes=((2, 1), (1, 2))) -> dict:
    """One stage-1 step of the tiny configs, f32, batch 2, from the same
    weights and draws, for each (data, fsdp) of ``meshes``: the port on two
    gloo ranks under FSDP2 (started first, running while the rest
    computes) and the JAX trainer's step on ``make_mesh`` of the same shape
    over ``jax.devices()[:2]`` (the programs compiled side by side in
    threads); and the port in one process. The JAX package's Laplace noise
    and contrastive indices are drawn from its keys and handed to the port.
    Returns {"one": ..., "lr": ..., (data, fsdp): {"jax", "ranks", "root"}}."""
    import json
    from concurrent.futures import ThreadPoolExecutor

    import optax
    import torch

    from ldiffusion_tpu.core.config import DiffusionTrainConfig as JConfig
    from ldiffusion_tpu.core.config import MeshConfig
    from ldiffusion_tpu.core.dist import make_mesh
    from ldiffusion_tpu.losses.infonce import InfoNceLoss as JInfoNce
    from ldiffusion_tpu.models.vgg import VGG19Features as JVGG
    from ldiffusion_tpu.train.ldiffusion import DiffusionWarmupTrainer as JTrainer
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents as TComponents
    from ldiffusion_tpu_torch.losses.infonce import ContrastIndices, InfoNceLoss
    from ldiffusion_tpu_torch.models.convert import flatten_tree
    from ldiffusion_tpu_torch.models.layers import init_random_
    from ldiffusion_tpu_torch.models.vgg import VGG19Features
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    s = STAGE1
    roots = {m: root / f"data{m[0]}_fsdp{m[1]}" for m in meshes}
    procs = {m: spawn_ranks("stage1", m[0] * m[1], roots[m], *m) for m in meshes}
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((2, 64, 64), np.int32)
    labels[:, :32] = 1
    labels[:, 32:, :32] = 2
    labels[-1, :8, :8] = 3
    vgg = init_random_(VGG19Features(), torch.Generator().manual_seed(7)).requires_grad_(False)
    vgg_flax = vgg_to_flax(vgg)
    key = jax.random.key(3)
    k_noise, k_contrast = jax.random.split(key)  # the JAX _loss_fn's split
    noise = jax_laplace_noise(k_noise, 1, (2, 32, 32, 4))  # steps // 5 = 1 PLMS step: 1 timestep
    idx = jax_contrast_indices(labels, k_contrast, s["negatives"], s["anchors"], s["classes"])
    for m in meshes:
        write_inputs(roots[m], images=images, labels=labels, noise=noise, config=json.dumps(s),
                     **dict(zip(("anchor", "positive", "negatives", "valid"), idx)),
                     **{f"vgg/{k}": v for k, v in flatten_tree(vgg_flax).items()})

    comps = TComponents.random(device="cpu")
    jc = jax_components_of(comps)
    programs = {}
    for m in meshes:
        mesh = make_mesh(MeshConfig(data=m[0], fsdp=m[1]), devices=jax.devices()[:2])
        jinfo_loss = JInfoNce(vgg=JVGG(), vgg_params=vgg_flax, num_anchors=s["anchors"],
                              num_negatives=s["negatives"], num_classes=s["classes"])
        # remat only changes what the backward keeps, not the values
        jtr = JTrainer(jc, JConfig(num_inference_steps=s["steps"], batch_size=2,
                                   num_classes=s["classes"], remat=False), mesh,
                       info_nce=jinfo_loss)

        def loss_fn(params, frozen, x, y, k, vgg_params, jinfo_loss=jinfo_loss, jtr=jtr):
            # the VGG weights as an argument: as the trainer's closure constants
            # they would be folded into the program, 80 MB that slow its compile
            jinfo_loss.vgg_params = vgg_params
            return jtr._loss_fn(params, frozen, x, y, k)

        def step(params, opt_state, frozen, x, y, k, vgg_params, loss_fn=loss_fn, jtr=jtr):
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, frozen, x, y, k, vgg_params)
            updates, opt_state = jtr.tx.update(grads, opt_state, params)
            return loss, grads, optax.apply_updates(params, updates), opt_state

        args = (jtr.state.params, jtr.state.opt_state, jtr.frozen,
                mesh.shard_batch(jnp.asarray(images)), mesh.shard_batch(jnp.asarray(labels)),
                key, vgg_flax)
        programs[m] = (jax.jit(step).lower(*args), args)
    with ThreadPoolExecutor(len(meshes)) as pool:  # XLA compiles them side by side
        compiled = dict(zip(meshes, pool.map(lambda m: programs[m][0].compile(), meshes)))
    out = {}
    for m in meshes:
        jloss, jgrads, jparams, opt_state = compiled[m](*programs[m][1])
        adam = next(a for a in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(a, "mu"))
        out[m] = {"root": roots[m], "jax": {
            "loss": float(jloss), **{f"grad/{k}": v for k, v in flat(jgrads).items()},
            **{f"param/{k}": v for k, v in flat(jparams).items()},
            **{f"mu/{k}": v for k, v in flat(adam.mu).items()},
            **{f"nu/{k}": v for k, v in flat(adam.nu).items()}}}

    one = DiffusionWarmupTrainer(
        comps, DiffusionTrainConfig(compute_dtype="float32", num_classes=s["classes"],
                                    num_inference_steps=s["steps"], remat=s["remat"]),
        info_nce=InfoNceLoss(vgg=vgg.eval(), num_anchors=s["anchors"],
                             num_negatives=s["negatives"], num_classes=s["classes"]))
    loss, _ = one.loss_and_grads(torch.from_numpy(images), torch.from_numpy(labels).long(),
                                 torch.from_numpy(noise),
                                 ContrastIndices(*(torch.from_numpy(a) for a in idx)))
    one_out = {"loss": float(loss),
               **{f"grad/{k}": v for k, v in flat(one._flax(one.state_dicts(
                   lambda m: m.grad.clone()))).items()}}
    one_out["norm"] = float(one.apply_update())
    st = one.opt.state
    for name, of in (("param", None), ("mu", lambda m: st[m]["exp_avg"]),
                     ("nu", lambda m: st[m]["exp_avg_sq"])):
        one_out.update({f"{name}/{k}": v for k, v in flat(one._flax(one.state_dicts(of))).items()})
    for m in meshes:
        out[m]["ranks"] = rank_outputs(procs[m], roots[m])
    out.update(one=one_out, lr=one.cfg.learning_rate)
    return out


def assert_step_close(got: dict, want: dict, grad_tol: float, nu_tol: float,
                      param_tol: float, lr: float):
    """Every gradient and AdamW moment within its tolerance of the tensor's
    largest value; the updated parameters within ``param_tol`` where the
    gradient exceeds 1e-3 of its tensor's largest value, elsewhere within
    the largest first Adam step, 2·lr (there g/(|g| + eps) is decided by
    gradient bits under the tolerance)."""
    for kind, tol in (("grad", grad_tol), ("mu", grad_tol), ("nu", nu_tol)):
        names = [k for k in want if k.startswith(kind + "/")]
        assert names and all(k in got for k in names), kind
        for k in names:
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            assert float(np.abs(got[k] - want[k]).max()) <= tol * scale, k
    for k in (k for k in want if k.startswith("param/")):
        g = np.abs(want["grad/" + k[6:]])
        tol = np.where(g > 1e-3 * g.max(), param_tol, 2 * lr)
        assert (np.abs(got[k] - want[k]) <= tol).all(), k


# the JAX device DA's draws (DA5 and the default stack) in the port's names
def _bump(key, h, w):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    sy = jnp.exp(jax.random.uniform(k1, (), minval=jnp.log(max(h / 6.0, 1.0)),
                                    maxval=jnp.log(float(h))))
    sx = jnp.exp(jax.random.uniform(k2, (), minval=jnp.log(max(w / 6.0, 1.0)),
                                    maxval=jnp.log(float(w))))
    my = jax.random.uniform(k3, (), minval=-0.5, maxval=1.5) * h
    mx = jax.random.uniform(k4, (), minval=-0.5, maxval=1.5) * w
    return np.asarray(jnp.stack([sy, sx, my, mx]))


def _draws_one(key, h, w, c, cfg):
    """One sample's draws of ``_augment_one``, in the port's parameter names."""
    r = jax.random
    ks = r.split(key, 16)
    u = np.asarray(r.uniform(ks[0], (12,)))
    ks5 = r.split(ks[13], 12)
    u5 = np.asarray(r.uniform(ks[14], (8,)))
    p = {"noise_on": u[2] < cfg.p_noise,
         "noise_var": r.uniform(ks[3], (), maxval=cfg.noise_var_max),
         "noise": np.asarray(r.normal(ks[4], (h, w, c))).transpose(2, 0, 1),
         "blur_on": u[3] < cfg.p_blur,
         "blur_sigma": r.uniform(ks[5], (), minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]),
         "median_pick": r.bernoulli(ks5[2], 0.5), "median_on": u5[2] < cfg.p_median,
         "median_size": r.randint(ks5[3], (), 0, 3),
         "brightness_on": u[4] < cfg.p_brightness,
         "brightness_shift": np.asarray(r.normal(ks[6], (c,))) * cfg.brightness_additive_sigma
         * np.asarray(r.bernoulli(ks[11], 0.5, (c,))),
         "contrast_on": u[5] < cfg.p_contrast,
         "contrast": r.uniform(ks[7], (), minval=cfg.contrast_range[0],
                               maxval=cfg.contrast_range[1]),
         "contrast_clip": r.bernoulli(ks[12], 0.5),
         "lowres_on": u[6] < cfg.p_lowres, "lowres_factor4": r.uniform(ks[8], ()) < 0.5,
         "gamma_invert_on": u[7] < cfg.p_gamma_invert,
         "gamma_invert": r.uniform(ks[9], (), minval=cfg.gamma_range[0],
                                   maxval=cfg.gamma_range[1]),
         "gamma_on": u[8] < cfg.p_gamma,
         "gamma": r.uniform(ks[10], (), minval=cfg.gamma_range[0], maxval=cfg.gamma_range[1]),
         "mirror_h": u[9] < cfg.p_mirror, "mirror_w": u[10] < cfg.p_mirror,
         "rot90_on": u5[0] < cfg.p_rot90, "rot90_k": r.randint(ks5[0], (), 0, 4),
         "transpose_on": u5[1] < cfg.p_transpose,
         "blank_on": u5[3] < cfg.p_blank_rect, "blank_n": r.randint(ks5[5], (), 1, 6),
         "blank_channels": r.bernoulli(ks5[6], 0.5, (c,)),
         "gradient_on": u5[4] < cfg.p_brightness_gradient, "gradient_bump": _bump(ks5[7], h, w),
         "local_gamma_on": u5[5] < cfg.p_local_gamma, "local_gamma_bump": _bump(ks5[9], h, w),
         "sharpen_on": u5[6] < cfg.p_sharpen,
         "sharpen_strength": r.uniform(ks5[11], (), minval=cfg.sharpen_strength[0],
                                       maxval=cfg.sharpen_strength[1])}
    rects = []
    for slot in r.split(ks5[4], 5):
        k1, k2, k3, k4 = r.split(slot, 4)
        rh = int(r.randint(k1, (), max(1, h // 10), max(2, h // 3 + 1)))
        rw = int(r.randint(k2, (), max(1, w // 10), max(2, w // 3 + 1)))
        rects.append([min(int(r.randint(k3, (), 0, h)), h - rh),
                      min(int(r.randint(k4, (), 0, w)), w - rw), rh, rw])
    p["blank_rects"] = np.asarray(rects)
    km, ksign, kon = r.split(ks5[8], 3)
    p["gradient_strength"] = np.asarray(
        r.uniform(km, (c,), minval=1.0, maxval=5.0)
        * jnp.where(r.bernoulli(ksign, 0.5, (c,)), 1.0, -1.0) * r.bernoulli(kon, 0.5, (c,)))
    kg1, kg2, kpick, kon = r.split(ks5[10], 4)
    p["local_gamma"] = np.asarray(jnp.where(r.bernoulli(kpick, 0.5, (c,)),
                                            r.uniform(kg1, (c,), minval=0.01, maxval=0.8),
                                            r.uniform(kg2, (c,), minval=1.5, maxval=4.0)))
    p["local_gamma_channels"] = r.bernoulli(kon, 0.5, (c,))
    return {k: np.asarray(v) for k, v in p.items()}


def jax_draws(key, shape, cfg):
    """The draws of ``jaug.augment_batch(key, ...)`` for an NHWC ``shape``,
    batched, as the port's parameter dict (the keys ``cfg`` enables)."""
    import torch

    from ldiffusion_tpu_torch.data import augment as taug

    b, h, w, c = shape
    per = [_draws_one(k, h, w, c, cfg) for k in jax.random.split(key, b)]
    tensors = {k: torch.from_numpy(np.stack([d[k] for d in per])) for k in per[0]}
    want = taug.draw_augment_params((b, c, h, w), cfg, torch.Generator().manual_seed(0))
    missing = set(want) - set(tensors)
    assert not missing, missing
    return {k: tensors[k] for k in want}


# the stage-1 training tests' set-up (test_torch_port_train*.py, _trajectory.py)
STAGE1_ANCHORS, STAGE1_NEGATIVES, STAGE1_CLASSES = 8, 16, 4


def stage1_vgg_params():
    """The JAX VGG19's parameters from key 7 (one jitted init)."""
    from ldiffusion_tpu.models.vgg import VGG19Features as JVGG

    return jax.jit(JVGG().init)(jax.random.key(7), jnp.zeros((1, 64, 64, 3)))["params"]


def stage1_data(batch=2, seed=0):
    """(images (B, 64, 64, 3), labels (B, 64, 64)): normal images, class
    bands 0-2, class 3 on a corner of the last image."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((batch, 64, 64), np.int32)
    labels[:, :32] = 1
    labels[:, 32:, :32] = 2
    labels[-1, :8, :8] = 3
    return images, labels


def port_stage1_trainer(jc, jax_vgg_params, **cfg):
    """The port's stage-1 trainer on the CPU in f32 from the JAX components'
    weights and VGG (``cfg``: more ``DiffusionTrainConfig`` fields)."""
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.models.vgg import VGG19Features, vgg_from_flax
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    comps = tpipe.SDComponents.from_flax(jc.params, device="cpu")
    vgg = VGG19Features()
    vgg.load_state_dict(vgg_from_flax(jax_vgg_params))
    info = InfoNceLoss(vgg=vgg.requires_grad_(False).eval(), num_anchors=STAGE1_ANCHORS,
                       num_negatives=STAGE1_NEGATIVES, num_classes=STAGE1_CLASSES)
    config = DiffusionTrainConfig(compute_dtype="float32", num_classes=STAGE1_CLASSES, **cfg)
    return DiffusionWarmupTrainer(comps, config, info_nce=info)
