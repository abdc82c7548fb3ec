"""The port's descriptor matcher against the reference's, on seeded inputs.

Both compute float32 squared distances as a^2 + b^2 - 2 ab; the indices must
be identical and the ratios agree within 1e-6 (they are about 0.1 to 1).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu.ops import matching as jax_matching
from glimpse_tpu_torch.ops import matching


def _descriptors(rng, n, base=None, noise=0.05):
    """SIFT-like descriptors: nonnegative unit 128-vectors; with ``base``,
    a shuffled noisy copy of it (so that true matches exist) plus new rows."""
    if base is None:
        d = rng.random((n, 128)) ** 3
    else:
        keep = rng.permutation(len(base))[: n // 2]
        d = np.vstack([base[keep] + noise * rng.random((len(keep), 128)), rng.random((n - len(keep), 128)) ** 3])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _stacks(seed=0):
    rng = np.random.default_rng(seed)
    a = _descriptors(rng, 300)
    return [a, _descriptors(rng, 260, a), _descriptors(rng, 170, a), _descriptors(rng, 1), _descriptors(rng, 90, a)]


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("max_ratio", [None, 0.75])
def test_match_matches_jax(max_ratio, cross_check) -> None:
    stacks = _stacks()
    ours = matching.DescriptorMatcher(pad_step=128, device="cpu")
    ref = jax_matching.DescriptorMatcher(pad_step=128)
    for a, b in [(0, 1), (1, 2), (2, 4), (0, 3)]:
        got = ours.match(stacks[a], stacks[b], max_ratio=max_ratio, cross_check=cross_check)
        want = ref.match(stacks[a], stacks[b], max_ratio=max_ratio, cross_check=cross_check)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        if b != 3:
            assert len(got[0]) > 5
    # The ratio and the cross check each drop matches.
    full = ours.match(stacks[0], stacks[1])[0]
    assert len(ours.match(stacks[0], stacks[1], max_ratio=max_ratio, cross_check=cross_check)[0]) <= len(full)


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_pairs_matches_jax(cross_check) -> None:
    """Pairs across stacks of other sizes in chunks of 2, a stack of one
    descriptor (no matches) among them; each pair equals ``match``."""
    stacks = _stacks(1)
    pairs = np.array([[0, 1], [0, 2], [1, 2], [3, 4], [2, 4], [4, 0], [1, 3]])
    ours = matching.DescriptorMatcher(pad_step=128, device="cpu")
    got = ours.match_pairs(stacks, pairs, max_ratio=0.75, cross_check=cross_check, batch=2)
    want = jax_matching.DescriptorMatcher(pad_step=128).match_pairs(
        stacks, pairs, max_ratio=0.75, cross_check=cross_check, batch=2
    )
    assert len(got) == len(pairs)
    # Every stack but the single descriptor crossed to the device once, at
    # the common padded size.
    assert sorted(k[1] for k in ours._device_cache) == [384] * (len(stacks) - 1)
    for (gi, gr), (wi, wr), (a, b) in zip(got, want, pairs):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gr, wr, atol=1e-6, rtol=0)
        single = ours.match(stacks[a], stacks[b], max_ratio=0.75, cross_check=cross_check)
        np.testing.assert_array_equal(gi, single[0])
    assert got[3][0].shape == (0, 2) and got[6][0].shape == (0, 2)


def test_ties_go_to_the_first_index() -> None:
    """Two identical descriptors in b: the nearest is the first of them, as
    jnp.argmin breaks the tie, and the ratio is 1 (0 for an exact copy)."""
    rng = np.random.default_rng(2)
    b = _descriptors(rng, 40)
    b[25] = b[7]
    a = b[[7, 3, 25]] + np.float32(0.01)
    got = matching.DescriptorMatcher(device="cpu").match(a, b)
    want = jax_matching.DescriptorMatcher().match(a, b)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0].tolist() == [0, 7] and got[0][2].tolist() == [2, 7]
    np.testing.assert_allclose(got[1][[0, 2]], 1.0, atol=1e-6)
