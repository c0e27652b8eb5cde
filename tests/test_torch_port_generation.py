"""The generation tail of the port — the noise schedule's tables, the DDIM and
LMS schedulers, ``make_scheduler``, ``tools/sample.py`` and
``tools/pixel_latent_vector.py`` — against the JAX package's, on the CPU at
the tiny configs in f32, from the same weights.

A torch generator cannot replay a JAX key, so the Laplace draws of the JAX
tools are taken from their keys along the tools' own ``split`` sequence and
handed to the port.

Tolerances:
- the schedule's tables and the LMS coefficient table: bit-equal (the same
  numpy and scipy calls on the same float32 inputs);
- a DDIM or LMS step: 1e-5 (the same float32 scalar arithmetic; torch may
  divide by a scalar as a product with its reciprocal);
- ``sample_steps``'s PNGs: within one 8-bit level, equal on ≥ 99% of pixels
  (decodes of a tiny stack summed in another order, ~1e-5 apart, rounded to
  uint8: a value at a rounding edge moves one level);
- ``dump_pixel_latent_vectors``'s CSV: image, y, x and label equal, the
  features within 1e-4 (the stage-1 trajectory's own tolerance,
  ``test_torch_port_train``).
"""
import csv

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ldiffusion_tpu.data.dataset import SegmentationDataset as JDataset
from ldiffusion_tpu.diffusion import schedule as jschedule
from ldiffusion_tpu.diffusion import schedulers as jsched
from ldiffusion_tpu.tools import pixel_latent_vector as jplv
from ldiffusion_tpu.tools import sample as jsample
from ldiffusion_tpu_torch import diffusion as tdiffusion
from ldiffusion_tpu_torch.data.dataset import SegmentationDataset, load_image
from ldiffusion_tpu_torch.diffusion import schedule as tschedule
from ldiffusion_tpu_torch.diffusion import schedulers as tsched
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
from ldiffusion_tpu_torch.tools import pixel_latent_vector as tplv
from ldiffusion_tpu_torch.tools import sample as tsample
from torch_port_common import jax_components_of, jax_laplace_noise, jitted
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

STEP_TOL = 1e-5
CSV_TOL = 1e-4
PNG_AGREEMENT = 0.99


@pytest.fixture(scope="module")
def components():
    return SDComponents.random(device="cpu")


@pytest.fixture(scope="module")
def jax_components(components):
    return jitted(jax_components_of(components))


def _roi(path, seed, size=64):
    rng = np.random.default_rng(seed)
    coarse = Image.fromarray((rng.random((size // 8, size // 8, 3)) * 255).astype(np.uint8))
    field = np.asarray(coarse.resize((size, size), Image.BICUBIC), np.float32)
    field += rng.normal(scale=8.0, size=field.shape)
    Image.fromarray(np.clip(field, 0, 255).astype(np.uint8)).save(path)
    return str(path)


# ---------------------------------------------------------------------------
# schedule and schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"beta_start": 0.0001, "beta_end": 0.02,
                                         "num_train_timesteps": 500, "steps_offset": 0,
                                         "set_alpha_to_one": True}])
def test_schedule_tables_are_bit_equal(kwargs):
    j, t = jschedule.scaled_linear_schedule(**kwargs), tschedule.scaled_linear_schedule(**kwargs)
    for name in ("betas", "alphas", "alphas_cumprod", "sigmas"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    steps = np.arange(j.num_train_timesteps)
    assert np.array_equal(t.laplace_scale(steps), j.laplace_scale(steps))
    assert (t.num_train_timesteps, t.steps_offset, t.final_alpha_cumprod) == \
        (j.num_train_timesteps, j.steps_offset, j.final_alpha_cumprod)
    if not kwargs:
        sd = tschedule.sd15_schedule()
        assert np.array_equal(sd.alphas_cumprod, jschedule.sd15_schedule().alphas_cumprod)


@pytest.mark.parametrize("name,steps", [("ddim", 1), ("ddim", 5), ("ddim", 50),
                                        ("lms", 1), ("lms", 5), ("lms", 25)])
def test_scheduler_steps_match_jax(name, steps):
    """Step by step on the same model outputs; LMS indexes by the loop index."""
    jsch, tsch = jsched.make_scheduler(name), tsched.make_scheduler(name)
    jts, ts = jsch.set_timesteps(steps), tsch.set_timesteps(steps)
    assert ts.values == jts.values and ts.step_ratio == jts.step_ratio
    assert np.array_equal(ts.array, jts.array) and ts.array.dtype == jts.array.dtype
    if name == "lms":
        _, sigmas, coeffs = tsch._tables(steps)
        assert np.array_equal(sigmas, jsch._sigmas)
        assert np.array_equal(coeffs, jsch._coeffs)  # the same scipy quad calls
        assert np.array_equal(tsch._sigmas, np.asarray(jsch._sigmas_jnp))
        assert np.array_equal(tsch._coeffs, np.asarray(jsch._coeffs_jnp))
    rng = np.random.default_rng(steps)
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = jsch.init_state(x.shape), tsch.init_state()
    for i, t in enumerate(ts.values):
        idx = i if name == "lms" else t
        jin = jsch.scale_model_input(jx, idx)
        tin = tsch.scale_model_input(tx, idx)
        np.testing.assert_allclose(tin.numpy(), np.asarray(jin), atol=STEP_TOL, rtol=STEP_TOL)
        eps = rng.normal(size=x.shape).astype(np.float32)
        jx, jstate = jsch.step(jts, jstate, jnp.asarray(eps), jnp.int32(idx), jx)
        tx, tstate = tsch.step(ts, tstate, torch.from_numpy(eps), idx, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=STEP_TOL, rtol=STEP_TOL)
    assert tstate.counter == int(jstate.counter) == len(ts.values)


def test_add_laplace_noise_and_scale_model_input_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    key = jax.random.key(3)
    for name in ("pndm", "ddim", "lms"):
        jsch, tsch = jsched.make_scheduler(name), tsched.make_scheduler(name)
        for t in (1, 501, 999):
            want = jsch.add_laplace_noise(key, jnp.asarray(x), jnp.int32(t))
            draw = torch.from_numpy(np.array(jax.random.laplace(key, x.shape, jnp.float32)))
            got = tsch.add_laplace_noise(torch.from_numpy(x), t, noise=draw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        if name != "lms":
            assert tsch.scale_model_input(torch.from_numpy(x), 1) is not None
            np.testing.assert_array_equal(tsch.scale_model_input(torch.from_numpy(x), 1).numpy(),
                                          np.asarray(jsch.scale_model_input(jnp.asarray(x), 1)))
    # a generator's draw: Laplace(0, sqrt(1 - alpha_bar_t))
    sch = tsched.PNDMScheduler()
    noisy = sch.add_laplace_noise(torch.zeros(200_000), 999,
                                  generator=torch.Generator().manual_seed(0))
    scale = float(sch.schedule.laplace_scale(999))
    assert abs(float(noisy.abs().mean()) / scale - 1.0) < 0.02  # E|Laplace(0, b)| = b


@pytest.mark.parametrize("name,cls", [("pndm", "PNDMScheduler"), ("PLMS", "PNDMScheduler"),
                                      ("ddim", "DDIMScheduler"), ("lms", "LMSScheduler"),
                                      ("LMSDiscrete", "LMSScheduler")])
def test_make_scheduler_names(name, cls):
    assert type(tsched.make_scheduler(name)).__name__ == cls == \
        type(jsched.make_scheduler(name)).__name__
    assert isinstance(tsched.make_scheduler(name), getattr(tdiffusion, cls))


def test_make_scheduler_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsched.make_scheduler("euler")


# ---------------------------------------------------------------------------
# the two tools
# ---------------------------------------------------------------------------

def _pngs(paths):
    return [np.asarray(Image.open(p), np.int16) for p in paths]


def test_sample_steps_matches_jax(jax_components, components, tmp_path):
    """PLMS with 2 steps visits 3 timesteps and writes 3 PNGs; the Laplace
    noise of each visit is the JAX tool's draw (key, sub = split(key))."""
    image = load_image(_roi(tmp_path / "roi.png", 0), (64, 64))
    jpaths = jsample.sample_steps(jax_components, image, 2, str(tmp_path / "jax"), seed=0)
    key, draws = jax.random.key(0), []
    for _ in jpaths:
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.laplace(sub, (1, 32, 32, 4), jnp.float32)))
    tpaths = tsample.sample_steps(components, image, 2, str(tmp_path / "torch"), noise=draws)
    assert [p.split("/")[-1] for p in tpaths] == [p.split("/")[-1] for p in jpaths]
    assert len(tpaths) == 3 and tpaths[0].endswith("step_00_t501.png")
    for a, b in zip(_pngs(tpaths), _pngs(jpaths)):
        assert a.shape == b.shape == (64, 64, 3)
        assert int(np.abs(a - b).max()) <= 1
        assert float(np.mean(a == b)) >= PNG_AGREEMENT


def test_sample_main_writes_a_png_a_visit_on_the_cpu(tmp_path, capsys):
    image = _roi(tmp_path / "roi.png", 1, size=80)
    out = tmp_path / "out"
    paths = tsample.main(["--diffusion-path", "random:tiny", "--image", image,
                          "--num-steps", "2", "--out-dir", str(out)], device="cpu")
    assert len(paths) == 3 and sorted(p.name for p in out.iterdir()) == \
        ["step_00_t501.png", "step_01_t1.png", "step_02_t1.png"]
    assert capsys.readouterr().out.split() == paths
    assert Image.open(paths[-1]).size == (64, 64)


def _pairs(root, n):
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        _roi(images / f"roi_{i}.png", 10 + i, size=96)
        Image.fromarray(rng.integers(0, 7, (96, 96)).astype(np.uint8)).save(labels / f"roi_{i}.png")
    return sorted(str(p) for p in images.iterdir()), sorted(str(p) for p in labels.iterdir())


def test_dump_pixel_latent_vectors_matches_jax(jax_components, components, tmp_path):
    """10 inference steps → 2 trajectory steps → 3 timesteps; each image's
    noise is the JAX tool's draw (key, sub = split(key); split(sub, T))."""
    images, labels = _pairs(tmp_path, 2)
    jplv.dump_pixel_latent_vectors(jax_components, JDataset(images, labels, "tissue"), 10,
                                   str(tmp_path / "jax.csv"), max_pixels_per_image=300)
    key = jax.random.key(0)

    def jax_draws(shape):
        nonlocal key
        key, sub = jax.random.split(key)
        return torch.from_numpy(jax_laplace_noise(sub, shape[0], shape[1:]))

    tplv.dump_pixel_latent_vectors(components, SegmentationDataset(images, labels, "tissue"), 10,
                                   str(tmp_path / "torch.csv"), max_pixels_per_image=300,
                                   draw_noise=jax_draws)
    rows = {}
    for name in ("jax", "torch"):
        with open(tmp_path / f"{name}.csv", newline="") as f:
            rows[name] = list(csv.reader(f))
    jrows, trows = rows["jax"], rows["torch"]
    assert trows[0] == jrows[0] == ["image", "y", "x", "label", "step_0", "step_1", "step_2"]
    assert len(trows) == len(jrows) == 1 + 2 * 300
    j, t = np.asarray(jrows[1:]), np.asarray(trows[1:])
    assert np.array_equal(t[:, :4], j[:, :4])
    np.testing.assert_allclose(t[:, 4:].astype(np.float64), j[:, 4:].astype(np.float64),
                               atol=CSV_TOL, rtol=0)


def test_pixel_latent_vector_main_on_the_cpu(tmp_path, capsys):
    images, labels = _pairs(tmp_path, 1)
    out = tmp_path / "pv.csv"
    tplv.main(["--diffusion-path", "random:tiny", "--image-dir", str(tmp_path / "images"),
               "--label-dir", str(tmp_path / "labels"), "--num-inference-steps", "4",
               "--out", str(out)], device="cpu")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["image", "y", "x", "label", "step_0"]  # max(1, 4 // 5) = 1 step
    assert len(rows) == 1 + 4096 and f"wrote {out}" in capsys.readouterr().out
