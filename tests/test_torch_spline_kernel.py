"""The spline read kernel's wrapper on the CPU, and the design it rests on.

On a CPU tensor ``kernels.spline.bspline_sample`` runs the plain version,
``ops.sampling.bspline_sample``. The CUDA kernel reads each tap's
ghost-folded value from a table computed once a surface, over tap indices
-1 to n + 1 on each axis; here that table and its reads are built in
PyTorch and held bit for bit to the plain version's per-tap fold, NaN and
+-inf included. The kernel itself is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``
(phase 29).
"""
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import spline_case
from glimpse_tpu_torch.kernels import _build, spline
from glimpse_tpu_torch.ops import sampling
from glimpse_tpu_torch.track import batch

DTYPES = ("float32", "bfloat16", "float16", "float64")
# Stacks of the cells' surfaces (the north star's 17x17, rung 4's 27x27), a
# non-square one and the smallest, at a particle count no block size divides.
SHAPES = ((64, 17, 17, 257), (16, 27, 27, 257), (8, 5, 9, 100), (4, 1, 2, 40), (4, 2, 1, 40))


def folded_table_read(coeffs, rows, cols):
    """The kernel's design in PyTorch: each surface's folded tap values at
    tap indices -1 to n + 1 on each axis, (h + 3) x (w + 3), computed as the
    plain version computes a tap; then 16 reads of that table a sample in
    the plain version's order. A sample whose floor lies on the grid reads
    the 4 x 4 block at its floor; any other reads the slot each tap's index
    falls in (below the grid, a cell, beyond it)."""
    B, H, W = coeffs.shape
    ri0, rw0, ri1, rw1 = sampling._natural_index(torch.arange(-1, H + 2), H)
    ci0, cw0, ci1, cw1 = sampling._natural_index(torch.arange(-1, W + 2), W)
    flat = coeffs.reshape(B, H * W)

    def tap(r, c):
        return flat[:, (r[:, None] * W + c[None, :]).reshape(-1)].reshape(B, H + 3, W + 3)

    table = (
        rw0[:, None] * cw0[None, :] * tap(ri0, ci0)
        + rw0[:, None] * cw1[None, :] * tap(ri0, ci1)
        + rw1[:, None] * cw0[None, :] * tap(ri1, ci0)
        + rw1[:, None] * cw1[None, :] * tap(ri1, ci1)
    ).reshape(B, -1)
    rb = torch.floor(rows)
    cb = torch.floor(cols)
    on_grid = (rb >= 0) & (rb <= H - 1) & (cb >= 0) & (cb <= W - 1)
    wr = sampling._cubic_bspline_weights(rows - rb)
    wc = sampling._cubic_bspline_weights(cols - cb)
    rb = rb.long()
    cb = cb.long()
    out = torch.zeros_like(rows)
    for dr in range(4):
        sr = torch.where(on_grid, rb + dr, torch.clamp(rb + (dr - 1), -1, H) + 1)
        for dc in range(4):
            sc = torch.where(on_grid, cb + dc, torch.clamp(cb + (dc - 1), -1, W) + 1)
            out = out + wr[dr] * wc[dc] * table.gather(1, sr * (W + 3) + sc)
    return out


def _types(name):
    """(coefficient type, coordinate type) pairs for a coefficient type: at
    each coordinate type the kernel takes, float32 (the tracker's for every
    surface type but float64) and float64."""
    return [(getattr(torch, name), coord_dtype) for coord_dtype in spline.COORD_DTYPES]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("name", DTYPES)
def test_wrapper_and_folded_table_equal_the_plain_version(shape, name) -> None:
    """Edges, points just inside them, points outside, NaN and +-inf
    coordinates and NaN and +-inf coefficients (``chip_smoke.spline_case``):
    the wrapper and the table read both equal ``sampling.bspline_sample``
    with rtol = atol = 0, NaN where it has NaN, in its output type."""
    for dtype, coord_dtype in _types(name):
        coeffs, rows, cols = spline_case(shape, dtype, coord_dtype, "cpu", seed=sum(shape))
        want = sampling.bspline_sample(coeffs, rows, cols)
        assert torch.isnan(want).any() and torch.isfinite(want).any()
        got = spline.bspline_sample(coeffs, rows, cols)
        assert got.dtype == want.dtype == (torch.float64 if torch.float64 in (dtype, coord_dtype) else torch.float32)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(folded_table_read(coeffs, rows, cols), want, rtol=0, atol=0, equal_nan=True)


def test_inside_the_grid_a_folded_tap_is_the_cell_or_nan() -> None:
    """Inside the grid the plain version's four-term fold of a cell c is
    c + 0 c: c itself, signed zeros included, or NaN where c is +-inf."""
    cells = torch.tensor([[[1.5, -0.0, 0.0, float("inf"), float("-inf"), float("nan"), -2.25, 3e38]]])
    rows = torch.zeros(1, 8)
    cols = torch.arange(8.0)[None]
    _, w0, _, w1 = sampling._natural_index(torch.arange(8), 8)
    value = w0 * w0 * cells[0, 0] + w0 * w1 * cells[0, 0] + w1 * w0 * cells[0, 0] + w1 * w1 * cells[0, 0]
    want = torch.where(torch.isinf(cells[0, 0]), float("nan"), cells[0, 0])
    torch.testing.assert_close(value, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.signbit(value[:3]), torch.signbit(cells[0, 0, :3]))
    torch.testing.assert_close(folded_table_read(cells, rows, cols), sampling.bspline_sample(cells, rows, cols),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "call",
    [
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(2, 8), torch.zeros(2, 7)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(3, 8), torch.zeros(3, 8)),
        lambda: spline.bspline_sample(torch.zeros(25, 5), torch.zeros(25, 8), torch.zeros(25, 8)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(2, 8, 1), torch.zeros(2, 8, 1)),
        lambda: spline.bspline_sample(torch.zeros(2, 0, 5), torch.zeros(2, 8), torch.zeros(2, 8)),
        lambda: spline.bspline_sample(torch.zeros(1, 5, 5), torch.zeros(1, spline.MAX_PARTICLES + 1),
                                      torch.zeros(1, spline.MAX_PARTICLES + 1)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5, dtype=torch.int32), torch.zeros(2, 8), torch.zeros(2, 8)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(2, 8, dtype=torch.int64),
                                      torch.zeros(2, 8, dtype=torch.int64)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.float64)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5, dtype=torch.bfloat16), torch.zeros(2, 8, dtype=torch.bfloat16),
                                      torch.zeros(2, 8, dtype=torch.bfloat16)),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5, device="meta"), torch.zeros(2, 8, device="meta"),
                                      torch.zeros(2, 8, device="meta")),
        lambda: spline.bspline_sample(torch.zeros(2, 5, 5), torch.zeros(2, 8, device="meta"), torch.zeros(2, 8)),
    ],
    ids=[
        "cols-shape", "rows-batch", "coeffs-2d", "rows-3d", "empty-surface", "oversize-P", "int32-coeffs",
        "int64-coords", "mixed-coords", "16-bit-coords", "meta-device", "two-devices",
    ],
)
def test_wrapper_refuses(call) -> None:
    """ValueError on what the kernel does not take: shapes, types, devices."""
    with pytest.raises(ValueError):
        call()


def test_the_step_program_counts_the_spline_kernel(monkeypatch) -> None:
    """A replay adds the captured spline launches to the wrapper's count,
    and the einsum read goes through the wrapper; the other modes do not."""
    assert _build.KERNELS["spline"].wrapper is spline.bspline_sample
    coeffs = torch.randn(3, 7, 7)
    rows, cols = torch.rand(3, 16) * 6, torch.rand(3, 16) * 6
    calls = []
    plain = spline.bspline_sample

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(batch.spline_kernel, "bspline_sample", spy)
    for mode in ("einsum", "nearest", "bilinear"):
        batch._read_spline(coeffs, rows, cols, batch.BatchConfig(sse_sample_mode=mode))
    assert len(calls) == 1 and calls[0][0] is coeffs


@pytest.mark.parametrize("name", DTYPES)
def test_bench_bytes_equal_the_roofline_readers(name) -> None:
    """``bench_spline.spline_bytes`` (chip_smoke phase 29 and the bench) and
    the benchmark's ``kernel.spline.roofline_pct`` reader, which imports
    nothing of the program, count the same bytes at the north star."""
    from glimpse_tpu_torch.kernels import bench_spline
    from portbench import cells

    reader = cells.load_module(cells.ROOT / "metrics" / "kernel.spline.roofline_pct.py")
    cell = cells.load_cell("columbia-2obs.north-star")
    cell["config"] = dict(cell["config"], dtype=name)
    cell["traffic"] = dict(cell["traffic"], points=10240, particles=2048)
    assert reader.spline_bytes(cell) == bench_spline.spline_bytes(bench_spline.SHAPES[0], getattr(torch, name))
