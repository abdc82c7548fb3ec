"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA card. The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run these there as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu_torch.kernels.highpass import median_highpass, median_highpass_plain
from glimpse_tpu_torch.kernels.resample import systematic_resample, systematic_resample_plain
from glimpse_tpu_torch.ops.resampling import systematic_thresholds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(3, 3), (5, 5), (7, 7), (1, 5), (3, 7), (3, 15), (1, 25)])
@pytest.mark.parametrize("shape", [(37, 41, 41), (37, 15, 15)])
def test_highpass_kernel_bit_exact(cuda, shape, size) -> None:
    tiles = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda)
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1
    assert torch.equal(got, median_highpass_plain(tiles, size))


@pytest.mark.cuda
@pytest.mark.parametrize("n, p", [(37, 1024), (64, 2048), (3, 20000)])
def test_resample_kernel_bit_exact(cuda, n, p) -> None:
    """Skewed weights exp(3 * normal); P = 20000 needs more than the 48 KB of
    shared memory a block gets without asking."""
    rng = np.random.default_rng(1)
    weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p))).astype(np.float32)).to(cuda)
    u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    particles = torch.from_numpy(rng.normal(size=(n, p, 6)).astype(np.float32)).to(cuda)
    t = systematic_thresholds(weights, u)
    before = systematic_resample.launches
    got = systematic_resample(t, particles, weights)
    assert systematic_resample.launches == before + 1
    want = systematic_resample_plain(t, particles, weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
