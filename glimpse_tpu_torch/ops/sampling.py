"""Grid sampling on tensors: nearest, bilinear and exact cubic B-spline.

The counterpart of :mod:`glimpse_tpu.ops.sampling`. Samples are read by plain
gathers at any grid size: the reference's gather-free forms (the one-hot
``grid_sample_*_dense`` matmuls, the dense spline basis) are TPU devices, and
here they are functions of the same name that compute the same values.
"""
import functools

import numpy as np
import torch

__all__ = [
    "nearest_sample",
    "bilinear_sample",
    "grid_sample_nearest_dense",
    "grid_sample_bilinear_dense",
    "DENSE_SAMPLE_MAX_CELLS",
    "bspline_prefilter_matrix",
    "bspline_prefilter_2d",
    "bspline_sample",
    "bspline_pad_coeffs",
    "bspline_sample_padded",
    "bspline_eval_matrix",
    "bspline_upsample",
    "bspline_basis_dense",
    "cubic_bspline_kernel",
    "sample_grid",
    "bspline_derivatives",
    "sample_grid_host",
]

#: The largest raster (cells) the reference samples by its one-hot matmuls
#: (``glimpse_tpu/ops/sampling.py``); its callers gather beyond it. The
#: port's ``grid_sample_*_dense`` gather at every size, so nothing here
#: depends on it: it is kept for callers that choose by it.
DENSE_SAMPLE_MAX_CELLS = 65536


def nearest_sample(values, rows, cols):
    """Sample a grid (H, W) at fractional indices, nearest neighbor
    (half-way cases round to the even index)."""
    H, W = values.shape[-2], values.shape[-1]
    r = torch.round(rows).long().clamp(0, H - 1)
    c = torch.round(cols).long().clamp(0, W - 1)
    return values[..., r, c]


def grid_sample_nearest_dense(values, ri, ci):
    """``values[ri, ci]`` of a grid (H, W) at integer index tensors of any
    one shape, by a gather.

    The reference computes this with one-hot row matmuls and masked column
    sums, for up to :data:`DENSE_SAMPLE_MAX_CELLS` cells, and there a NaN
    cell poisons every sample in its column (0 * NaN). Here the gather runs
    at any grid size, and a NaN cell reaches only the samples taken at it.
    Indices must lie in the grid, as on the reference's domain.
    """
    return values[ri.long(), ci.long()]


def grid_sample_bilinear_dense(values, rows, cols):
    """:func:`bilinear_sample` of a grid (H, W) under the reference's name
    for its one-hot form: the same values (edge extrapolation included), by
    four gathers, at any grid size. A NaN cell reaches only the samples
    whose four-cell stencil holds it, where the reference's one-hot matmul
    spreads it down its column."""
    return bilinear_sample(values, rows, cols)


def bilinear_sample(values, rows, cols):
    """Sample a grid (H, W) at fractional indices, bilinearly.

    Out-of-bounds indices extrapolate linearly from the edge cells. A NaN
    cell reaches only the samples whose four-cell stencil holds it.
    """
    H, W = values.shape[-2], values.shape[-1]
    r0f = torch.clamp(torch.floor(rows), 0, max(H - 2, 0))
    c0f = torch.clamp(torch.floor(cols), 0, max(W - 2, 0))
    r0 = r0f.long()
    c0 = c0f.long()
    r1 = torch.clamp(r0 + 1, max=H - 1)
    c1 = torch.clamp(c0 + 1, max=W - 1)
    fr = rows - r0f
    fc = cols - c0f
    v00 = values[..., r0, c0]
    v01 = values[..., r0, c1]
    v10 = values[..., r1, c0]
    v11 = values[..., r1, c1]
    top = v00 + (v01 - v00) * fc
    bot = v10 + (v11 - v10) * fc
    return top + (bot - top) * fr


@functools.lru_cache(maxsize=128)
def bspline_prefilter_matrix(n: int) -> np.ndarray:
    """Inverse (float64) of the cubic B-spline collocation matrix for n nodes.

    Natural boundary conditions: the ghost coefficients c[-1] = 2 c[0] - c[1]
    and c[n] = 2 c[n-1] - c[n-2] are folded into the end columns.
    """
    if n == 1:
        return np.ones((1, 1))
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 4 / 6
        if i > 0:
            A[i, i - 1] += 1 / 6
        if i < n - 1:
            A[i, i + 1] += 1 / 6
    A[0, 0] += 2 * (1 / 6)
    A[0, 1] -= 1 / 6
    A[n - 1, n - 1] += 2 * (1 / 6)
    A[n - 1, n - 2] -= 1 / 6
    return np.linalg.inv(A)


def bspline_prefilter_2d(values):
    """Cubic B-spline coefficients of a (..., H, W) grid: Ar @ values @ Ac^T.

    The inverses are built in float64 on the host and cast to the values'
    type. On the card a float32 matmul runs in full float32 unless the
    caller has enabled TF32 for matmuls.
    """
    H, W = values.shape[-2], values.shape[-1]
    Ar = _prefilter_tensor(H, values.device, values.dtype)
    Ac = _prefilter_tensor(W, values.device, values.dtype)
    return torch.matmul(torch.matmul(Ar, values), Ac.T)


@functools.lru_cache(maxsize=16)
def _prefilter_tensor(n: int, device, dtype) -> torch.Tensor:
    # Kept on the device: a fresh host-to-device copy each step would make
    # the host wait for the card.
    return torch.as_tensor(bspline_prefilter_matrix(n)).to(device, dtype)


def _cubic_bspline_weights(t):
    """Basis values for nodes at offsets (-1, 0, 1, 2) of fractional offset t."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1 - 3 * t + 3 * t2 - t3) / 6
    w1 = (4 - 6 * t2 + 3 * t3) / 6
    w2 = (1 + 3 * t + 3 * t2 - 3 * t3) / 6
    w3 = t3 / 6
    return w0, w1, w2, w3


def _natural_index(i, n: int):
    """Coefficient index with natural-BC ghosts: c_i = w0 c[i0] + w1 c[i1]."""
    below = i < 0
    above = i > n - 1
    ghost = below | above
    i0 = torch.where(below, 0, torch.where(above, n - 1, i))
    i1 = torch.where(below, min(1, n - 1), torch.where(above, max(n - 2, 0), i))
    w0 = torch.where(ghost, 2.0, 1.0)
    w1 = torch.where(ghost, -1.0, 0.0)
    return i0, w0, i1, w1


def bspline_sample(coeffs, rows, cols):
    """Evaluate cubic B-splines at fractional indices: 16 taps per sample.

    ``coeffs`` (B, H, W) from :func:`bspline_prefilter_2d`; ``rows`` and
    ``cols`` (B, Q). Returns (B, Q).
    """
    B, H, W = coeffs.shape
    flat = coeffs.reshape(B, H * W)
    rb = torch.floor(rows)
    cb = torch.floor(cols)
    wr = _cubic_bspline_weights(rows - rb)
    wc = _cubic_bspline_weights(cols - cb)
    rb = rb.long()
    cb = cb.long()

    def tap(r, c):
        return flat.gather(1, r * W + c)

    out = torch.zeros_like(rows)
    for dr in range(4):
        ri0, rw0, ri1, rw1 = _natural_index(rb + (dr - 1), H)
        for dc in range(4):
            ci0, cw0, ci1, cw1 = _natural_index(cb + (dc - 1), W)
            val = (
                rw0 * cw0 * tap(ri0, ci0)
                + rw0 * cw1 * tap(ri0, ci1)
                + rw1 * cw0 * tap(ri1, ci0)
                + rw1 * cw1 * tap(ri1, ci1)
            )
            out = out + wr[dr] * wc[dc] * val
    return out


def cubic_bspline_kernel(x):
    """The cubic B-spline kernel b3(x) (support |x| < 2)."""
    ax = torch.abs(x)
    ax2 = ax * ax
    inner = (4.0 - 6.0 * ax2 + 3.0 * ax2 * ax) / 6.0
    t = torch.clamp(2.0 - ax, min=0.0)
    outer = t * t * t / 6.0
    return torch.where(ax < 1.0, inner, outer)


def bspline_basis_dense(q, n: int, dtype=None):
    """Dense natural-BC cubic B-spline basis: B of shape ``q.shape + (n,)``
    with ``B @ c`` the spline of coefficients c (n,) at queries q in
    [0, n - 1]. The ghosts c[-1] = 2 c[0] - c[1] and c[n] = 2 c[n-1] - c[n-2]
    are folded into the end columns, as in :func:`bspline_sample`."""
    dtype = dtype or q.dtype
    grid = torch.arange(n, dtype=dtype, device=q.device)
    B = cubic_bspline_kernel(q[..., None] - grid)
    fold_lo = np.zeros(n, np.float64)
    fold_lo[0] += 2.0
    fold_lo[min(1, n - 1)] -= 1.0
    fold_hi = np.zeros(n, np.float64)
    fold_hi[n - 1] += 2.0
    fold_hi[max(n - 2, 0)] -= 1.0
    B = B + cubic_bspline_kernel(q + 1.0)[..., None] * torch.as_tensor(fold_lo, dtype=dtype, device=q.device)
    return B + cubic_bspline_kernel(q - n)[..., None] * torch.as_tensor(fold_hi, dtype=dtype, device=q.device)


def bspline_pad_coeffs(coeffs):
    """Coefficients (..., H, W) with the natural-BC ghosts folded into a
    one-cell border (..., H + 2, W + 2): c[-1] = 2 c[0] - c[1] and
    c[n] = 2 c[n-1] - c[n-2] on each axis, so each tap is one gather."""
    c = torch.cat([2 * coeffs[..., :1, :] - coeffs[..., 1:2, :], coeffs,
                   2 * coeffs[..., -1:, :] - coeffs[..., -2:-1, :]], dim=-2)
    return torch.cat([2 * c[..., :1] - c[..., 1:2], c, 2 * c[..., -1:] - c[..., -2:-1]], dim=-1)


def bspline_sample_padded(padded, rows, cols):
    """Evaluate cubic B-splines from ghost-padded coefficients: 16 taps.

    ``padded`` (B, H + 2, W + 2) from :func:`bspline_pad_coeffs`; ``rows``
    and ``cols`` (B, Q) index the unpadded grid. Equals :func:`bspline_sample`
    for indices within one cell of the grid, which every clamped index is.
    """
    B, H2, W2 = padded.shape
    flat = padded.reshape(B, H2 * W2)
    rb = torch.floor(rows)
    cb = torch.floor(cols)
    wr = _cubic_bspline_weights(rows - rb)
    wc = _cubic_bspline_weights(cols - cb)
    rb = rb.long() + 1  # into the padded frame
    cb = cb.long() + 1
    out = torch.zeros_like(rows)
    for dr in range(4):
        ri = torch.clamp(rb + (dr - 1), 0, H2 - 1)
        for dc in range(4):
            ci = torch.clamp(cb + (dc - 1), 0, W2 - 1)
            out = out + wr[dr] * wc[dc] * flat.gather(1, ri * W2 + ci)
    return out


@functools.lru_cache(maxsize=64)
def bspline_eval_matrix(n: int, factor: int) -> np.ndarray:
    """E (n * factor, n), float64: ``E @ coeffs`` is the 1-D cubic B-spline
    at fine positions (j + 0.5) / factor - 0.5, j in [0, n * factor): fine
    cells centred over the coarse grid, natural-BC ghosts folded in."""
    m = n * factor
    positions = (np.arange(m) + 0.5) / factor - 0.5
    E = np.zeros((m, n))
    base = np.floor(positions).astype(int)
    w = _cubic_bspline_weights(positions - base)
    for tap in range(4):
        idx = base + (tap - 1)
        for j in range(m):
            i = idx[j]
            wt = w[tap][j]
            if i < 0:
                E[j, 0] += 2 * wt
                E[j, min(1, n - 1)] -= wt
            elif i > n - 1:
                E[j, n - 1] += 2 * wt
                E[j, max(n - 2, 0)] -= wt
            else:
                E[j, i] += wt
    return E


@functools.lru_cache(maxsize=16)
def _eval_tensor(n: int, factor: int, device, dtype) -> torch.Tensor:
    # Kept on the device, as the prefilter's matrices are.
    return torch.as_tensor(bspline_eval_matrix(n, factor)).to(device, dtype)


def bspline_upsample(coeffs, factor: int, dtype=None):
    """The 2-D cubic B-spline of coefficients (..., H, W) on a
    ``factor``-times finer grid (..., H * factor, W * factor), by two
    matmuls: fine cell (i, j) is centred at coarse index
    ((i + 0.5) / factor - 0.5, (j + 0.5) / factor - 0.5)."""
    H, W = coeffs.shape[-2], coeffs.shape[-1]
    dtype = dtype or coeffs.dtype
    Er = _eval_tensor(H, factor, coeffs.device, dtype)
    Ec = _eval_tensor(W, factor, coeffs.device, dtype)
    return torch.matmul(torch.matmul(Er, coeffs.to(dtype)), Ec.T)


def _cubic_bspline_slopes(t):
    """First and second derivatives in t of :func:`_cubic_bspline_weights`."""
    t2 = t * t
    d = ((-3 + 6 * t - 3 * t2) / 6, (-12 * t + 9 * t2) / 6, (3 + 6 * t - 9 * t2) / 6, 3 * t2 / 6)
    dd = (1 - t, -2 + 3 * t, 1 - 3 * t, t)
    return d, dd


def bspline_derivatives(coeffs, rows, cols):
    """Value, gradient and Hessian of the cubic B-spline at fractional indices.

    ``coeffs`` (B, H, W) from :func:`bspline_prefilter_2d`; ``rows`` and
    ``cols`` (B, Q) within [0, H - 1] and [0, W - 1]. Returns six (B, Q)
    tensors: value, d/drow, d/dcol, d2/drow2, d2/dcol2, d2/drow dcol. The 16
    taps carry the natural-boundary ghosts of :func:`bspline_sample`, so at
    the edges 0 and n - 1 they equal the reference's dense basis and its
    derivatives; a tap beyond the ghost has weight and slopes 0 there.
    """
    B, H, W = coeffs.shape
    flat = bspline_pad_coeffs(coeffs).reshape(B, (H + 2) * (W + 2))
    rb = torch.floor(rows)
    cb = torch.floor(cols)
    tr = rows - rb
    tc = cols - cb
    wr, (dr_, ddr) = _cubic_bspline_weights(tr), _cubic_bspline_slopes(tr)
    wc, (dc_, ddc) = _cubic_bspline_weights(tc), _cubic_bspline_slopes(tc)
    rb = rb.long()
    cb = cb.long()
    out = [torch.zeros_like(rows) for _ in range(6)]
    for i in range(4):
        r = torch.clamp(rb + i, 0, H + 1)
        for j in range(4):
            v = flat.gather(1, r * (W + 2) + torch.clamp(cb + j, 0, W + 1))
            for n, (a, b) in enumerate(
                ((wr, wc), (dr_, wc), (wr, dc_), (ddr, wc), (wr, ddc), (dr_, dc_))
            ):
                out[n] = out[n] + a[i] * b[j] * v
    return tuple(out)


def sample_grid(values, rows, cols, order: int = 1, prefiltered: bool = False):
    """Sample a 2-D grid (H, W) at fractional indices of any one shape.

    order 0: nearest; 1: bilinear; 3: exact interpolating cubic B-spline.
    With ``prefiltered=True``, ``values`` are already spline coefficients.
    """
    if order == 0:
        return nearest_sample(values, rows, cols)
    if order == 1:
        return bilinear_sample(values, rows, cols)
    if order == 3:
        coeffs = values if prefiltered else bspline_prefilter_2d(values)
        out = bspline_sample(coeffs[None], rows.reshape(1, -1), cols.reshape(1, -1))
        return out.reshape(rows.shape)
    raise ValueError(f"Unsupported interpolation order: {order}")


def sample_grid_host(array: np.ndarray, rows, cols, order: int = 1) -> np.ndarray:
    """:func:`sample_grid` for the host objects: float64 arrays in and out,
    through CPU tensors over the arrays' memory."""
    return sample_grid(
        torch.from_numpy(np.ascontiguousarray(array, dtype=float)),
        torch.from_numpy(np.ascontiguousarray(rows, dtype=float)),
        torch.from_numpy(np.ascontiguousarray(cols, dtype=float)),
        order=order,
    ).numpy()
