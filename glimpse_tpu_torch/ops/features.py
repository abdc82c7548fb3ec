"""Keypoint detection and upright descriptors on tensors.

The counterpart of :mod:`glimpse_tpu.ops.features`, written in the direct
form on the card:

- scale space: a separable Gaussian ladder per octave (two ``conv2d`` with
  zero padding) and its difference-of-Gaussian (DoG) levels;
- extrema: a 3x3x3 (scale, y, x) ``max_pool3d``; a pixel is a candidate
  where it equals the pooled extremum, passes the contrast threshold and the
  Hessian edge test;
- selection: the best ``quota`` scores per octave, by a stable descending
  sort, so equal scores keep the lower flat index first, as ``lax.top_k``;
- subpixel: the 3D (x, y, scale) Newton fit, either walked on the lattice
  (``refine="lattice"``, cv2's adjustLocalExtrema, with the dense fit as
  fallback) or dense plus one resampled step (``"bilinear"``);
- descriptors: gradient magnitude soft-binned into 8 orientation planes,
  blurred, read on a 4x4 cell grid by bilinear gathers; L2-normalized,
  clipped at 0.2 and renormalized (128 floats, SIFT's layout).

Keypoint coordinates follow the cv2 convention (array indices, subpixel).
:func:`detect_and_describe` runs each batch through a :class:`BatchProgram`,
one a batch shape, as the reference compiles ``_detect_batch`` once a shape
and setting: on a card a replay of a graph captured from
:func:`detect_batch`.
"""
import contextlib
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import graphs
from .matching import full_float32

_GAUSS_RADIUS = 3.0


def _gauss_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(_GAUSS_RADIUS * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _kernel_tensor(sigma: float, device) -> torch.Tensor:
    return torch.from_numpy(_gauss_kernel(sigma)).to(device)


def _blur(x, sigma: float, full_precision: bool = True):
    """Separable Gaussian blur of (B, H, W) with zero padding.

    The Gaussian ladder needs ``full_precision``: a DoG level is a small
    difference of two blurs, and cuDNN's default TF32 (ten mantissa bits)
    would put a texture-coherent error into it that biases localization.
    The descriptor planes feed a normalized vector and take the default.
    """
    k = _kernel_tensor(sigma, x.device)
    r = len(k) // 2
    with full_float32() if full_precision else contextlib.nullcontext():
        y = F.conv2d(x[:, None], k.view(1, 1, 1, -1), padding=(0, r))
        y = F.conv2d(y, k.view(1, 1, -1, 1), padding=(r, 0))
    return y[:, 0]


def _shift(x, dy: int, dx: int):
    """Shift (..., H, W) by (dy, dx) with edge replication: out[i, j] =
    x[clamp(i - dy), clamp(j - dx)]."""
    H, W = x.shape[-2], x.shape[-1]
    core = x[..., max(-dy, 0) : H - max(dy, 0), max(-dx, 0) : W - max(dx, 0)]
    return F.pad(core, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)), mode="replicate")


def _fused_bilinear_rows(maps_flat, W: int, H: int, yy, xx):
    """Bilinear samples of (B, H*W, C) maps at float (B, ...) coordinates,
    all C channels per gather; returns (B, ..., C)."""
    yy, xx = torch.broadcast_tensors(yy, xx)
    x0 = torch.clamp(torch.floor(xx), 0, W - 2)
    y0 = torch.clamp(torch.floor(yy), 0, H - 2)
    fx = torch.clamp(xx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(yy - y0, 0.0, 1.0)[..., None]
    base = (y0.long() * W + x0.long()).reshape(yy.shape[0], -1)
    C = maps_flat.shape[-1]

    def take(offset):
        index = (base + offset)[..., None].expand(-1, -1, C)
        return torch.gather(maps_flat, 1, index).reshape(*yy.shape, C)

    top = take(0) * (1 - fx) + take(1) * fx
    bot = take(W) * (1 - fx) + take(W + 1) * fx
    return top * (1 - fy) + bot * fy


def _newton3(gr, hs):
    """-H^-1 g for the symmetric 3x3 (x, y, s) system, each offset clipped to 0.6."""
    gdx, gdy, gds = gr
    hxx, hyy, hss, hxy, hxs, hys = hs
    a11 = hyy * hss - hys * hys
    a12 = hxs * hys - hxy * hss
    a13 = hxy * hys - hyy * hxs
    a22 = hxx * hss - hxs * hxs
    a23 = hxy * hxs - hxx * hys
    a33 = hxx * hyy - hxy * hxy
    det3 = hxx * a11 + hxy * a12 + hxs * a13
    safe = torch.where(torch.abs(det3) > 1e-12, det3, torch.full_like(det3, 1e-12))
    ox = torch.clamp(-(a11 * gdx + a12 * gdy + a13 * gds) / safe, -0.6, 0.6)
    oy = torch.clamp(-(a12 * gdx + a22 * gdy + a23 * gds) / safe, -0.6, 0.6)
    os_ = torch.clamp(-(a13 * gdx + a23 * gdy + a33 * gds) / safe, -0.6, 0.6)
    return ox, oy, os_


def _octave_detect(gauss, mask, quota: int, n_scales: int, sigma0: float, contrast_threshold: float,
                   edge_ratio: float, border: int, refine: str = "lattice"):
    """Detect and describe within one octave.

    ``gauss`` (B, L, H, W) Gaussian ladder (L = n_scales + 3); ``mask``
    (B, H, W) eroded validity or None. Returns y, x (octave coordinates,
    subpixel), level, score, desc (B, quota, 128) and valid, each with
    ``quota`` slots per image.
    """
    B, L, H, W = gauss.shape
    dog = gauss[:, 1:] - gauss[:, :-1]  # (B, L-1, H, W)
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    center = dog[:, 1:-1]  # levels 1..n_scales
    is_ext = ((center >= mx[:, 1:-1]) & (center > 0)) | ((center <= mn[:, 1:-1]) & (center < 0))

    def d_x(a):  # central differences; _shift(a, 0, 1) carries a[j - 1] to j
        return 0.5 * (_shift(a, 0, -1) - _shift(a, 0, 1))

    def d_y(a):
        return 0.5 * (_shift(a, -1, 0) - _shift(a, 1, 0))

    dxx = _shift(center, 0, 1) + _shift(center, 0, -1) - 2 * center
    dyy = _shift(center, 1, 0) + _shift(center, -1, 0) - 2 * center
    dxy = 0.25 * (_shift(center, 1, 1) + _shift(center, -1, -1) - _shift(center, 1, -1) - _shift(center, -1, 1))
    dx = d_x(center)
    dy = d_y(center)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < det * (r + 1) ** 2)
    score = torch.where(is_ext & edge_ok & (torch.abs(center) >= contrast_threshold), torch.abs(center), 0.0)
    ys = torch.arange(H, device=gauss.device)
    xs = torch.arange(W, device=gauss.device)
    in_border = ((ys >= border) & (ys < H - border))[:, None] & ((xs >= border) & (xs < W - border))[None, :]
    score = torch.where(in_border, score, 0.0)
    if mask is not None:
        score = score * mask[:, None]
    # Scale-axis derivatives for the full 3x3 (x, y, scale) Newton fit.
    up, down = dog[:, 2:], dog[:, :-2]
    ds = 0.5 * (up - down)
    dss = up + down - 2 * center
    dxs = 0.5 * (d_x(up) - d_x(down))
    dys = 0.5 * (d_y(up) - d_y(down))

    top_scores, top_idx = torch.sort(score.reshape(B, -1), dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :quota], top_idx[:, :quota]
    valid = top_scores > 0
    lvl = top_idx // (H * W)
    rem = top_idx - lvl * (H * W)
    iy = rem // W
    ix = rem - iy * W
    # (B, S*H*W, 10); channel 9 is D, for the contrast recheck.
    dflat = torch.stack([dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys, center], dim=-1).reshape(B, n_scales * H * W, 10)

    def resampled_step(fx0, fy0, lv):
        """One Newton step with the nine derivative maps sampled bilinearly
        at (fx0, fy0) on level ``lv``; the level stack is one tall (S*H, W)
        image and the inner y clip keeps the support on the point's level."""
        d9 = _fused_bilinear_rows(
            dflat[..., :9], W, n_scales * H, lv.float() * H + torch.clamp(fy0, 1.0, H - 2.0),
            torch.clamp(fx0, 1.0, W - 2.0),
        )
        step_x, step_y, _ = _newton3(tuple(d9[..., i] for i in range(3)), tuple(d9[..., i] for i in range(3, 9)))
        return fx0 + torch.clamp(step_x, -0.5, 0.5), fy0 + torch.clamp(step_y, -0.5, 0.5)

    def dense_refine():
        """Dense one-step 3D Newton, sampled at the keypoints, plus one
        resampled step."""
        off_x, off_y, _ = _newton3((dx, dy, ds), (dxx, dyy, dss, dxy, dxs, dys))
        off = torch.stack([off_x, off_y], dim=-1).reshape(B, -1, 2)
        off_sel = torch.gather(off, 1, top_idx[..., None].expand(-1, -1, 2))
        return resampled_step(ix + off_sel[..., 0], iy + off_sel[..., 1], lvl)

    if refine == "lattice":
        # The lattice walk: fit the 3D quadratic from the exact grid
        # derivatives; while the offset leaves the centre cell, move to the
        # rounded neighbour (clamped to the interior) and refit; five steps.
        px, py, ps = ix, iy, lvl
        for _ in range(5):
            d10 = torch.gather(dflat, 1, ((ps * H + py) * W + px)[..., None].expand(-1, -1, 10))
            ox, oy, os_ = _newton3(tuple(d10[..., i] for i in range(3)), tuple(d10[..., i] for i in range(3, 9)))
            inside = (torch.abs(ox) < 0.5) & (torch.abs(oy) < 0.5) & (torch.abs(os_) < 0.5)

            def step(o):
                return torch.clamp(torch.round(o), -1, 1).long()

            px = torch.where(inside, px, torch.clamp(px + step(ox), border, W - 1 - border))
            py = torch.where(inside, py, torch.clamp(py + step(oy), border, H - 1 - border))
            ps = torch.where(inside, ps, torch.clamp(ps + step(os_), 0, n_scales - 1))
        # Keypoints whose last fit still leaves the cell take the dense
        # refinement from the original candidate instead.
        converged = (torch.abs(ox) < 0.5) & (torch.abs(oy) < 0.5) & (torch.abs(os_) < 0.5)
        # cv2's interpolated-contrast recheck: |D + 0.5 g . offset|.
        d_hat = d10[..., 9] + 0.5 * (d10[..., 0] * ox + d10[..., 1] * oy + d10[..., 2] * os_)
        valid = valid & (torch.abs(d_hat) >= contrast_threshold)
        top_scores = torch.where(valid, torch.abs(d_hat), 0.0)
        fx_b, fy_b = dense_refine()
        fx = torch.where(converged, px.float() + torch.clamp(ox, -0.5, 0.5), fx_b)
        fy = torch.where(converged, py.float() + torch.clamp(oy, -0.5, 0.5), fy_b)
        lvl = torch.where(converged, ps, lvl)
    else:
        fx, fy = dense_refine()

    # Descriptors: blurred orientation-bin maps at each centre level.
    k_geo = 2.0 ** (1.0 / n_scales)
    bins = torch.arange(8, device=gauss.device).reshape(1, 8, 1, 1)
    descs = []
    for lev in range(n_scales):
        g = gauss[:, lev + 1]
        gx = d_x(g)
        gy = d_y(g)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        theta = torch.atan2(gy, gx)
        tb = (theta / (2 * np.pi) * 8.0) % 8.0
        b0 = torch.floor(tb)
        frac = tb - b0
        b0 = b0.long() % 8
        b1 = (b0 + 1) % 8
        planes = mag[:, None] * (
            (b0[:, None] == bins) * (1 - frac[:, None]) + (b1[:, None] == bins) * frac[:, None]
        )  # (B, 8, H, W)
        cell = 3.0 * sigma0 * (k_geo**lev)  # descriptor cell spacing, octave pixels
        planes = _blur(planes.reshape(B * 8, H, W), cell * 0.5, full_precision=False).reshape(B, 8, H, W)
        maps_flat = planes.permute(0, 2, 3, 1).reshape(B, H * W, 8)
        grid = (torch.arange(4, dtype=torch.float32, device=gauss.device) - 1.5) * cell
        gyy = fy[..., None, None] + grid[None, None, :, None]
        gxx = fx[..., None, None] + grid[None, None, None, :]
        descs.append(_fused_bilinear_rows(maps_flat, W, H, gyy, gxx).reshape(B, quota, 128))
    desc = torch.stack(descs, dim=2)  # (B, quota, n_scales, 128)
    desc = torch.gather(desc, 2, lvl[..., None, None].expand(-1, -1, 1, 128))[:, :, 0]
    # SIFT's illumination contract: L2 normalize, clip at 0.2, renormalize.
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    return fy, fx, lvl, top_scores, desc, valid


def upsample2(x, mode: str):
    """2x resize of (B, H, W) with half-pixel centres: ``"bilinear"`` is
    ``jax.image.resize(..., "linear")`` (edges replicate), ``"nearest"`` its
    ``"nearest"``."""
    H, W = x.shape[-2:]
    kwargs = {"align_corners": False} if mode == "bilinear" else {}
    return F.interpolate(x[:, None], size=(2 * H, 2 * W), mode=mode, **kwargs)[:, 0]


def detect_batch(images, mask=None, nfeatures: int = 2048, n_octaves: int = 4, n_scales: int = 3,
                 sigma0: float = 1.6, contrast_threshold: float = 0.006, edge_ratio: float = 10.0, border: int = 8,
                 upsample: bool = True, refine: str = "lattice"):
    """Detect and describe on a batch (B, H, W) of uint8-valued images.

    ``mask`` (B, H, W), nonzero where keypoints may lie, or None. Returns
    pts (B, K, 2) float32 [x, y], size (B, K), score (B, K), desc
    (B, K, 128) and valid (B, K), K = ``nfeatures``; slots are ordered
    octave-major by score. ``upsample`` prepends SIFT's 2x octave.
    """
    if refine not in ("lattice", "bilinear"):
        raise ValueError(f"refine must be 'lattice' or 'bilinear', not {refine!r}")
    x = images.float() / 255.0
    m = None if mask is None else mask.float()
    coord_scale = 1.0
    if upsample:
        x = upsample2(x, "bilinear")
        if m is not None:
            m = upsample2(m, "nearest")
        coord_scale = 0.5
    # Octave quotas: halving, the remainder to octave 0.
    quotas = []
    rest = nfeatures
    for o in range(n_octaves):
        q = nfeatures // (2 ** (o + 1)) if o < n_octaves - 1 else rest
        q = max(min(q, rest), 1)
        quotas.append(q)
        rest -= q
    quotas[0] += rest
    k_geo = 2.0 ** (1.0 / n_scales)
    outs = []
    # The input is taken to carry sigma 0.5 (1.0 after upsampling); the
    # base level tops that up to sigma0.
    sigma_in = 1.0 if upsample else 0.5
    base = _blur(x, math.sqrt(max(sigma0**2 - sigma_in**2, 0.01)))
    for o in range(n_octaves):
        ladder = [base]
        for s in range(1, n_scales + 3):
            prev_sigma = sigma0 * (k_geo ** (s - 1))
            ladder.append(_blur(ladder[-1], prev_sigma * math.sqrt(k_geo * k_geo - 1.0)))
        gauss = torch.stack(ladder, dim=1)  # (B, L, Ho, Wo)
        mo = None
        if m is not None:
            # Erode by the border radius, so no descriptor support crosses
            # the mask's edge; the image's edge does not erode.
            mo = -F.max_pool2d(-m[:, None], 2 * border + 1, stride=1, padding=border)[:, 0]
            mo = (mo > 0.5).float()
        fy, fx, lvl, score, desc, valid = _octave_detect(
            gauss, mo, quotas[o], n_scales, sigma0, contrast_threshold, edge_ratio, border, refine=refine
        )
        scale_mult = float(2**o) * coord_scale
        # Half-pixel centres: upsampled coordinate u lies at original
        # (u + 0.5) / 2 - 0.5, a constant -0.25 px through the decimations.
        shift = -0.25 if upsample else 0.0
        pts = torch.stack([fx * scale_mult + shift, fy * scale_mult + shift], dim=-1)
        size = sigma0 * (k_geo ** (lvl + 1)) * scale_mult * 2.0
        outs.append((pts, size, score, desc, valid))
        if o < n_octaves - 1:
            base = gauss[:, n_scales][:, ::2, ::2]
            if m is not None:
                m = m[:, ::2, ::2]
    return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(5))


class BatchProgram:
    """:func:`detect_batch` at one batch shape and one set of settings as a
    program over static buffers (:class:`graphs.Program`): the images (B,
    H, W) uint8 and, where ``masked``, their masks (B, H, W) uint8 on
    ``device``. A call copies a batch in and returns ``detect_batch``'s
    outputs, bit for bit the eager call's; read them before the next call."""

    def __init__(self, shape, masked: bool, device, **settings) -> None:
        device = torch.device(device)
        self.images = torch.zeros(shape, dtype=torch.uint8, device=device)
        self.masks = torch.zeros(shape, dtype=torch.uint8, device=device) if masked else None
        self.program = graphs.Program(functools.partial(detect_batch, self.images, self.masks, **settings), device,
                                      f"keypoint detection on {tuple(shape)} images")

    def __call__(self, images: np.ndarray, masks: Optional[np.ndarray] = None):
        self.images.copy_(torch.from_numpy(images))
        if self.masks is not None:
            self.masks.copy_(torch.from_numpy(masks))
        return self.program()


def detect_and_describe(arrays: Sequence[np.ndarray], masks: Optional[Sequence[Optional[np.ndarray]]] = None,
                        nfeatures: int = 2048, batch: int = 16, device="cuda",
                        **kwargs) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Keypoints and descriptors for a list of grayscale images (H, W).

    Images go to ``device`` ``batch`` at a time (all of a batch share a
    shape); the last batch is filled up with copies of its last image.
    ``masks``: optional per-image masks (nonzero = detect here; None = the
    whole image). Returns ``(pts (n, 2) float32, descriptors (n, 128)
    float32)`` per image, n <= ``nfeatures``, in the slots' order.
    """
    device = torch.device(device)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    programs = {}
    for start in range(0, len(arrays), batch):
        chunk = [np.asarray(a) for a in arrays[start : start + batch]]
        rows = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch - rows)
        imgs = np.stack(chunk).astype(np.uint8)
        mrows = None
        if masks is not None:
            sub = list(masks[start : start + rows])
            if any(mk is not None for mk in sub):
                mrows = np.ones(imgs.shape, dtype=np.uint8)
                for i, mk in enumerate(sub):
                    if mk is not None:
                        mrows[i] = np.asarray(mk) > 0
        key = (imgs.shape, mrows is not None)
        if key not in programs:
            programs[key] = BatchProgram(*key, device, nfeatures=nfeatures, **kwargs)
        pts, _, _, desc, valid = programs[key](imgs, mrows)
        pts, desc, valid = pts.cpu().numpy(), desc.cpu().numpy(), valid.cpu().numpy()
        for i in range(rows):
            keep = np.flatnonzero(valid[i])
            out.append((pts[i][keep].astype(np.float32), np.ascontiguousarray(desc[i][keep], dtype=np.float32)))
    return out
