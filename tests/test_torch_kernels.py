"""The port's two kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain version (the tensor lies on the CPU);
these are held bit for bit against the Pallas kernels in interpret mode.
The CUDA kernels themselves are compared with the plain versions on the card
by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from chip_smoke import highpass_tiles
from glimpse_tpu.kernels.highpass_pallas import median_highpass as pallas_highpass
from glimpse_tpu.kernels.resample_pallas import systematic_resample_gather
from glimpse_tpu.ops import imageproc as jax_imageproc
from glimpse_tpu_torch.kernels.highpass import median_highpass
from glimpse_tpu_torch.kernels.resample import MAX_PARTICLES, systematic_resample
from glimpse_tpu_torch.ops import resampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _skewed_thresholds(rng, N, P):
    w = np.exp(3.0 * rng.normal(size=(N, P))).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    cum = np.cumsum(w / w.sum(-1, keepdims=True), -1, dtype=np.float32)
    return (P * cum - u[:, None]).astype(np.float32)


@pytest.mark.parametrize(
    "shape, size",
    [((5, 41, 41), (5, 5)), ((5, 15, 15), (5, 5)), ((5, 41, 41), (7, 7))],
)
def test_highpass_plain_bit_exact(shape, size) -> None:
    """Bit-equal to the Pallas kernel (interpret mode) and to the reference's
    sort-median high-pass."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ours = median_highpass(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(ours, np.asarray(pallas_highpass(jnp.asarray(x), size=size, interpret=True)))
    np.testing.assert_array_equal(ours, np.asarray(jax_imageproc.highpass(jnp.asarray(x), size=size, xp=jnp)))


@pytest.mark.parametrize(
    "shape, size",
    [
        ((6, 31, 31), (5, 5)), ((6, 41, 41), (5, 5)), ((6, 15, 15), (5, 5)),  # the main path's tiles
        ((6, 15, 15), (3, 3)), ((6, 15, 15), (7, 7)), ((6, 15, 15), (3, 7)), ((6, 15, 15), (9, 5)),
        ((6, 15, 15), (3, 11)), ((6, 3, 3), (5, 5)),
    ],
)
def test_highpass_plain_holds_nan_ties_and_inf(shape, size) -> None:
    """The semantics the card's kernel is held to: on tiles of tied values
    with a NaN pixel at a corner, an edge and inside and +-inf pixels
    (``chip_smoke.highpass_tiles``), the plain version has the NaN mask of
    the Pallas kernel (interpret mode) and of the reference's sort-median
    high-pass, and equal values elsewhere."""
    x = highpass_tiles(shape, seed=2)
    ours = median_highpass(torch.from_numpy(x), size).numpy()
    assert np.isnan(ours).any() and np.isinf(x).any()
    for reference in (
        pallas_highpass(jnp.asarray(x), size=size, interpret=True),
        jax_imageproc.highpass(jnp.asarray(x), size=size, xp=jnp),
    ):
        np.testing.assert_array_equal(ours, np.asarray(reference))


def test_resample_plain_bit_exact() -> None:
    """Bit-equal to the Pallas kernel (interpret mode), N = 37 (not a
    multiple of any block), P = 256, skewed weights exp(3 * normal). Half
    the rows are rounded to quarter steps, so thresholds tie with slots."""
    rng = np.random.default_rng(1)
    N, P = 37, 256
    t = _skewed_thresholds(rng, N, P)
    t[::2] = np.round(t[::2] * 4) / 4
    particles = rng.normal(size=(N, P, 6)).astype(np.float32)
    weights = rng.random((N, P)).astype(np.float32)
    new_p, new_w = systematic_resample(
        torch.from_numpy(t), torch.from_numpy(particles), torch.from_numpy(weights)
    )
    cols = [jnp.asarray(particles[..., k]) for k in range(6)] + [jnp.asarray(weights)]
    out = [np.asarray(c) for c in systematic_resample_gather(jnp.asarray(t), cols, interpret=True)]
    np.testing.assert_array_equal(new_p.numpy(), np.stack(out[:6], axis=-1))
    np.testing.assert_array_equal(new_w.numpy(), out[6])


def test_resample_left_tie_rule() -> None:
    """A threshold equal to slot j does not count toward it: searchsorted
    side='left', the Pallas kernel's rule (the reference's merge-rank
    search, ops/resampling.py:_batched_searchsorted, would count it)."""
    t = torch.tensor([[0.0, 1.0, 1.0, 3.0]])
    np.testing.assert_array_equal(resampling.systematic_indices(t).numpy(), [[0, 1, 3, 3]])
    particles = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    new_p, new_w = systematic_resample(t, particles, torch.arange(4.0)[None])
    np.testing.assert_array_equal(new_w.numpy(), [[0.0, 1.0, 3.0, 3.0]])
    np.testing.assert_array_equal(new_p[0, :, 0].numpy(), [0.0, 6.0, 18.0, 18.0])


@pytest.mark.parametrize(
    "call",
    [
        lambda: median_highpass(torch.zeros(2, 9, 9), (4, 5)),
        lambda: median_highpass(torch.zeros(2, 9, 9), (9, 9)),
        lambda: median_highpass(torch.zeros(2, 9, 9).transpose(1, 2), (5, 5)),
        lambda: median_highpass(torch.zeros(2, 9, 2, dtype=torch.float64), (5, 4)),
        lambda: median_highpass(torch.zeros(2, 9, 9, dtype=torch.int32), (5, 5)),
        lambda: median_highpass(torch.zeros(2, 0, 9), (5, 5)),
        lambda: systematic_resample(
            torch.zeros(1, MAX_PARTICLES + 1), torch.zeros(1, MAX_PARTICLES + 1, 6),
            torch.zeros(1, MAX_PARTICLES + 1),
        ),
        lambda: systematic_resample(
            torch.zeros(8, 4).T, torch.zeros(4, 8, 6), torch.zeros(4, 8)
        ),
        lambda: systematic_resample(
            torch.zeros(4, 8), torch.zeros(4, 6, 8).transpose(1, 2), torch.zeros(4, 8)
        ),
        lambda: median_highpass(torch.zeros(2, 9, 9, device="meta"), (5, 5)),
        lambda: systematic_resample(
            *(torch.zeros(shape, device="meta") for shape in [(4, 8), (4, 8, 6), (4, 8)])
        ),
    ],
    ids=[
        "even-taps", "too-many-taps", "noncontiguous-tiles", "float64-tiles", "int32-tiles",
        "tile-too-small", "oversize-P", "noncontiguous-t", "noncontiguous-particles",
        "highpass-meta-device", "resample-meta-device",
    ],
)
def test_wrappers_refuse(call) -> None:
    """Each wrapper raises ValueError on what its kernel does not take; the
    float64 case is an even window, the small tile one with no rows (a tile
    of any other size is taken, whatever its element type)."""
    with pytest.raises(ValueError):
        call()


def test_import_needs_no_jax_and_no_nvcc() -> None:
    """Importing the package pulls in no jax, and the kernels' modules import
    and run their plain versions with no CUDA toolkit on the path."""
    code = (
        "import sys, torch\n"
        "import glimpse_tpu_torch\n"
        "from glimpse_tpu_torch.kernels import _build, bench_prior, bench_project, highpass, prior, project, resample,"
        " spline\n"
        "assert 'jax' not in sys.modules and 'glimpse_tpu' not in sys.modules\n"
        "highpass.median_highpass(torch.zeros(2, 9, 9))\n"
        "resample.systematic_resample(torch.zeros(2, 8), torch.zeros(2, 8, 6), torch.ones(2, 8))\n"
        "spline.bspline_sample(torch.zeros(2, 5, 5), torch.ones(2, 8), torch.ones(2, 8))\n"
        "project.project_extract(**bench_project.inputs((2, 4, 8, 16, 16, 3, 3, 7, 7), torch.float32, 'cpu'))\n"
        "prior.dem_prior(**bench_prior.inputs((8, 16, 12, 10), torch.float32, 'cpu'))\n"
        "assert _build._load.cache_info().currsize == _build.entry.cache_info().currsize == 0\n"
        "assert set(_build.KERNELS) == {source.stem for source in _build.SOURCE_DIR.glob('*.cu')}\n"
        "assert all(k.wrapper.launches == k.wrapper.captured == 0 for k in _build.KERNELS.values())\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
