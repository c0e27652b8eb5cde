"""The segmentor networks this port adds, against the JAX package's, on the CPU
in float32 at tiny widths: BatchNorm (nnUNetTrainerBN) in training and
evaluation with its running statistics, the residual encoder (ResEnc-M
schedule), the flax-layout conversion with ``batch_stats``, and the
``resenc`` plan.

Tolerances (float32 on both sides; only the order of sums differs):
- forward outputs (every deep-supervision head): 1e-4 absolute, the logits
  being O(1);
- running statistics after a training forward: 1e-5 absolute (the mean is
  O(0.1), the variance O(1)); the biased variance makes flax's number, the
  unbiased one (``nn.BatchNorm2d``'s) differs by var/(n-1), far above that;
- the conversion round trip and the plans: exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.models.dynunet import DynUNetConfig as JConfig
from ldiffusion_tpu.models.dynunet import RESENC_M_BLOCKS as J_RESENC_M
from ldiffusion_tpu.segmentor import planner as jplan
from ldiffusion_tpu_torch.models import dynunet as tdyn
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.models.convert import (
    dynunet_batch_stats_to_flax,
    dynunet_from_flax,
    dynunet_rows,
    dynunet_to_flax,
)
from ldiffusion_tpu_torch.segmentor import planner as tplan

FWD_TOL = 1e-4
STATS_TOL = 1e-5

# (norm, block_type, n_blocks): the two norms on the plain net, the residual
# encoder with InstanceNorm and with BatchNorm
NETS = [("batch", "plain", ()), ("instance", "residual", (1, 2, 2)),
        ("batch", "residual", (2, 1, 3))]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(norm, block, blocks, ds=True):
    kw = dict(in_channels=3, num_classes=4, features_per_stage=(8, 16, 32),
              strides=(1, 2, 2), n_conv_per_stage=2, deep_supervision=ds, norm=norm,
              block_type=block, n_blocks_per_stage=blocks)
    return JConfig(**kw), tdyn.DynUNetConfig(**kw)


def _init(tcfg, seed=3):
    """Seeded weights in the flax layout ({"params", "batch_stats"}), drawn
    by the port and converted (a flax init compiles for seconds on the CPU;
    ``test_resenc_m_forward_and_convert_round_trip`` holds the converted
    tree against flax's own)."""
    net = init_random_(tdyn.DynUNet(tcfg), torch.Generator().manual_seed(seed))
    sd = net.state_dict()
    variables = {"params": dynunet_to_flax(sd, tcfg)}
    if tcfg.norm == "batch":
        variables["batch_stats"] = dynunet_batch_stats_to_flax(sd, tcfg)
    return variables


def _apply(jcfg, variables, x, **kw):
    """The flax forward."""
    return JDynUNet(jcfg).apply(variables, jnp.asarray(x), **kw)


def _port(tcfg, variables):
    net = tdyn.DynUNet(tcfg)
    net.load_state_dict(dynunet_from_flax(variables["params"], tcfg,
                                          variables.get("batch_stats")))
    return net


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _shift_stats(variables, rng):
    """Running statistics away from their initial 0/1, so evaluation reads them."""
    def shift(path, v):
        name = path[-1].key
        d = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        return v + d if name == "mean" else v + 0.5 + np.abs(d)

    stats = jax.tree_util.tree_map_with_path(shift, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


@pytest.mark.parametrize("norm,block,blocks", NETS)
def test_training_forward_and_running_statistics_match_flax(norm, block, blocks):
    jcfg, tcfg = _cfgs(norm, block, blocks)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 16, 16, 3)) * 1.5 + 0.3).astype(np.float32)
    variables = _init(tcfg)
    net = _port(tcfg, variables)
    jout, upd = _apply(jcfg, variables, x, train=True, mutable=["batch_stats"])
    tout = net(_nchw(x), train=True)
    assert len(tout) == len(jout) == 2
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   atol=FWD_TOL, rtol=0)
    if norm == "batch":
        got = dynunet_batch_stats_to_flax(net.state_dict(), tcfg)
        want = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
        flat_g, flat_w = _flat(got), _flat(want)
        assert flat_g.keys() == flat_w.keys()
        for k in flat_w:
            np.testing.assert_allclose(flat_g[k], flat_w[k], atol=STATS_TOL, rtol=0, err_msg=k)
    else:
        assert dynunet_batch_stats_to_flax(net.state_dict(), tcfg) == {}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("norm,block,blocks", NETS)
def test_evaluation_forward_reads_the_running_statistics(norm, block, blocks):
    jcfg, tcfg = _cfgs(norm, block, blocks)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    variables = _init(tcfg)
    if norm == "batch":
        variables = _shift_stats(variables, rng)
    net = _port(tcfg, variables)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    jout = _apply(jcfg, variables, x, train=False)
    with torch.no_grad():
        tout = net(_nchw(x))
    np.testing.assert_allclose(tout.permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=0)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


def test_batchnorm_running_variance_is_the_biased_one():
    """flax folds the biased batch variance into its running variance; torch's
    BatchNorm2d the unbiased: only the biased formula gives flax's number."""
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    _, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    port = tdyn.BatchNorm(3)
    port(_nchw(x), train=True)
    np.testing.assert_allclose(port.running_var.numpy(), want, atol=1e-6, rtol=0)
    torch_bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    torch_bn(_nchw(x))
    assert np.abs(torch_bn.running_var.detach().numpy() - want).max() > 1e-3


def test_resenc_m_forward_and_convert_round_trip():
    """The ResEnc-M schedule over 7 stages at narrow widths: flax names,
    parameter count, forward, and flax → port → flax with batch_stats."""
    assert tdyn.RESENC_M_BLOCKS == J_RESENC_M
    feats = (4, 8, 8, 8, 8, 8, 8)
    kw = dict(in_channels=3, num_classes=3, features_per_stage=feats,
              strides=(1, 2, 2, 2, 2, 2, 2), deep_supervision=False, norm="batch",
              block_type="residual")
    jcfg, tcfg = JConfig(**kw), tdyn.DynUNetConfig(**kw)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    variables = _init(tcfg)
    # flax's own tree (traced, not compiled): the same paths and shapes
    shapes = jax.eval_shape(JDynUNet(jcfg).init, jax.random.key(0), jnp.zeros(x.shape))
    for coll in ("params", "batch_stats"):
        want = {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]}
        got = {jax.tree_util.keystr(k): tuple(v.shape)
               for k, v in jax.tree_util.tree_flatten_with_path(variables[coll])[0]}
        assert got == want, coll
    rows = dynunet_rows(tcfg)
    flax_paths = {p for p in _flat(variables["params"]) if p.endswith(("kernel", "scale"))}
    assert flax_paths == {f"{fp}/{'scale' if kind == 'norm' else 'kernel'}"
                          for _, fp, kind in rows}
    net = _port(tcfg, variables)
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == sum(v.size for v in _flat(variables["params"]).values())
    with torch.device("meta"):
        assert sum(p.numel() for p in tdyn.DynUNet(tcfg).parameters()) == n_params
    jout = _apply(jcfg, variables, x, train=False)
    with torch.no_grad():
        tout = net(_nchw(x))
    np.testing.assert_allclose(tout.permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=0)
    back = {"params": dynunet_to_flax(net.state_dict(), tcfg),
            "batch_stats": dynunet_batch_stats_to_flax(net.state_dict(), tcfg)}
    for coll in ("params", "batch_stats"):
        a, b = _flat(back[coll]), _flat(variables[coll])
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batchnorm_state_dict_without_batch_stats_holds_the_parameters():
    """Optimizer buffers convert without statistics; a net's load then needs
    them, so a BatchNorm checkpoint without ``batch_stats`` cannot load."""
    _, tcfg = _cfgs("batch", "plain", ())
    net = tdyn.DynUNet(tcfg)
    sd = dynunet_from_flax(dynunet_to_flax(net.state_dict(), tcfg), tcfg)
    assert set(sd) == {k for k, _ in net.named_parameters()}
    with pytest.raises(RuntimeError, match="running_mean"):
        net.load_state_dict(sd)


@pytest.mark.parametrize("shapes", [[[1024, 1024]] * 6, [[64, 64], [80, 72]],
                                    [[512, 768]] * 3])
def test_resenc_plan_equals_jax(shapes):
    fp = {"shapes_after_crop": shapes, "num_channels": 3,
          "foreground_intensity_properties_per_channel": {}}
    tp = tplan.plan_experiment(fp, 7, planner="resenc")
    jp = jplan.plan_experiment(fp, 7, planner="resenc")
    assert tp.to_json() == jp.to_json()
    net = tp.network_config()
    assert net.block_type == "residual" and net.n_blocks_per_stage == tp.n_blocks_per_stage
    if shapes[0] == [1024, 1024]:
        # the ResEnc-M plan of six 1024² cases
        assert (tp.patch_size, tp.batch_size, tp.features_per_stage,
                tp.n_blocks_per_stage) == ((512, 512), 2, (32, 64, 128, 256, 512, 512, 512),
                                           (1, 3, 4, 6, 6, 6, 6))


def test_unknown_planner_raises():
    with pytest.raises(ValueError, match="planner"):
        tplan.plan_experiment({"shapes_after_crop": [[64, 64]]}, 3, planner="resenc_xl")


def test_plan_network_config_carries_the_block_schedule():
    plan = tplan.SegPlan(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16),
                         strides=(1, 2), n_conv_per_stage=2, num_classes=3, in_channels=3,
                         normalization="zscore_image", intensity_properties={},
                         median_shape=(32, 32), batch_dice=True, block_type="residual",
                         n_blocks_per_stage=(1, 3))
    cfg = plan.network_config()
    assert tdyn.encoder_blocks(cfg) == (1, 3)
    assert dataclasses.replace(cfg, n_blocks_per_stage=()).n_blocks_per_stage == ()


def test_batchnorm_checkpoint_predicts_with_its_running_statistics(tmp_path):
    """A BatchNorm checkpoint (``batch_stats`` non-empty) is evaluated by the
    port's predictor with a BatchNorm net and its running statistics, as
    flax's ``train=False`` gives. The JAX predictor builds its net from the
    plan alone and so evaluates the same checkpoint with InstanceNorm over
    the BatchNorm affine parameters (ROADMAP queue 3): pinned here."""
    import pickle

    from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor

    jcfg, tcfg = _cfgs("batch", "plain", (), ds=True)
    plan_kw = dict(patch_size=(16, 16), batch_size=2, features_per_stage=(8, 16, 32),
                   strides=(1, 2, 2), n_conv_per_stage=2, num_classes=4, in_channels=3,
                   normalization="zscore_image", intensity_properties={},
                   median_shape=(16, 16), batch_dice=True)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(16, 16, 3)).astype(np.float32)
    variables = _shift_stats(_init(tcfg), rng)
    ck = tmp_path / "checkpoint_final.pkl"
    with open(ck, "wb") as f:
        pickle.dump({"params": variables["params"], "batch_stats": variables["batch_stats"]}, f)
    port = TPredictor.from_checkpoints(tplan.SegPlan(**plan_kw), [str(ck)], dtype=torch.float32,
                                       device="cpu", use_mirroring=False)
    got = port.predict_logits(img, normalize=False)
    want = np.asarray(_apply(jcfg, variables, img[None], train=False))[0]
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    jax_pred = JPredictor.from_checkpoints(jplan.SegPlan(**plan_kw), [str(ck)],
                                           dtype=jnp.float32, use_mirroring=False)
    theirs = jax_pred.predict_logits(img, normalize=False)
    instance = np.asarray(_apply(dataclasses.replace(jcfg, norm="instance"),
                                 {"params": variables["params"]}, img[None], train=False))[0]
    np.testing.assert_allclose(theirs, instance, atol=FWD_TOL, rtol=0)
    assert np.abs(theirs - want).max() > 0.1
