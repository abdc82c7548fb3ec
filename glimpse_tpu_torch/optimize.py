"""Sequence stabilization on tensors: matched rays and the view-direction fit.

The counterpart of the device part of :mod:`glimpse_tpu.optimize`:

- :class:`RotationMatchesXYZ`, one image pair's matches as undistorted
  normalized camera coordinates (``xys``), from camera vectors and pixels;
- :class:`ObserverCameras`, the view directions of one observer's images
  that minimize the smoothed L1 norm of unit-ray differences over all
  matches, with anchor frames held fixed: a chained Procrustes start
  (:meth:`ObserverCameras.initialize`) and the fit on an autograd objective
  (:meth:`ObserverCameras.fit`);
- :func:`detect_keypoints_device` and :func:`match_keypoints_device`, thin
  wrappers of :mod:`.ops.features` and :mod:`.ops.matching`.

The reference's ``Camera``, ``KeypointMatcher`` (pickle caches, image
reading, CLAHE) and ``Cameras`` are host API, not ported yet: cameras here
are 20-float vectors (:mod:`.ops.projection`).
"""
import collections
import math
from typing import Iterable, Optional

import numpy as np
import scipy.optimize
import scipy.sparse
import torch

from .ops import features, projection
from .ops.matching import DescriptorMatcher, full_float32


class RotationMatchesXYZ:
    """Matched points of one image pair as camera coordinates, for
    :class:`ObserverCameras`.

    ``cams`` are the two images' 20-float camera vectors; ``uvs`` the two
    (n, 2) pixel arrays or ``xys`` the two (n, 2) normalized camera
    coordinate arrays. Without ``xys`` they come from ``uvs`` through
    :func:`ops.projection.image_to_camera` in float64 on the host. The
    reference's objects of the same name pass into :class:`ObserverCameras`
    as they are: it reads only ``xys`` and ``size``.
    """

    def __init__(self, cams, uvs=None, xys=None, weights=None) -> None:
        if uvs is None and xys is None:
            raise ValueError("Both uvs and xys are missing")
        self.cams = [np.asarray(c, dtype=float) for c in cams]
        self.weights = weights
        self.uvs = None if uvs is None else [np.asarray(uv, dtype=float) for uv in uvs]
        if xys is None:
            xys = [
                projection.image_to_camera(
                    torch.from_numpy(uv), c[projection.IMGSZ], c[projection.F], c[projection.C],
                    c[projection.K], c[projection.P],
                ).numpy()
                for c, uv in zip(self.cams, self.uvs)
            ]
        self.xys = [np.asarray(xy, dtype=float) for xy in xys]
        if len(self.xys[0]) != len(self.xys[1]):
            raise ValueError("The two images have different numbers of points")

    @property
    def size(self) -> int:
        """Number of point pairs."""
        return len(self.xys[0])


def _coo(matches):
    return matches if scipy.sparse.issparse(matches) else scipy.sparse.coo_matrix(matches)


class ObserverCameras:
    """View directions of an observer's image sequence from keypoint matches.

    ``observer`` is anything with ``images[i].cam.viewdir`` (degrees);
    ``matches`` a scipy sparse matrix (COO) whose entry (i, j) is the
    matches of images i and j (``xys`` and ``size``); ``anchors`` the images
    whose view directions stay fixed. The objective and its gradient run on
    ``device``.
    """

    def __init__(self, observer, matches=None, anchors: Iterable[int] = None, device="cuda") -> None:
        self.observer = observer
        self.anchors = [0] if anchors is None else list(anchors)
        self.matches = matches
        self.device = torch.device(device)
        self.viewdirs = np.vstack([np.array(img.cam.viewdir, dtype=float) for img in self.observer.images])

    def set_cameras(self, viewdirs) -> None:
        """Write view directions into the observer's cameras."""
        for i, img in enumerate(self.observer.images):
            img.cam.viewdir = viewdirs[i]

    def reset_cameras(self) -> None:
        """Restore the original view directions."""
        self.set_cameras(viewdirs=self.viewdirs.copy())

    def initialize(self, min_matches: int = 8) -> np.ndarray:
        """View directions (n_images, 3) chained from pairwise rotations.

        For each consecutive pair with at least ``min_matches`` matches, the
        relative rotation is the orthogonal-Procrustes optimum over the
        matched unit rays (one 3x3 SVD, float64 on the host); composing them
        outward from the first anchor gives the start. An image with no such
        pair keeps its neighbour's rotation. Does not change the cameras.
        """
        coo = _coo(self.matches)
        pair_map = {(int(i), int(j)): m for m, i, j in zip(coo.data, coo.row, coo.col) if m.size >= min_matches}

        def unit(v):
            v = np.column_stack([v, np.ones(len(v))])
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        def relative(m, R_known, forward: bool):
            """Rotation of the unknown image given the known image's R."""
            va, vb = unit(m.xys[0]), unit(m.xys[1])
            if not forward:  # the unknown is the first image of the pair
                va, vb = vb, va
            U, _, Vt = np.linalg.svd(vb.T @ (va @ R_known))
            d = np.sign(np.linalg.det(U @ Vt))
            return U @ np.diag([1.0, 1.0, d]) @ Vt

        def viewdir(R):
            return projection.viewdir_from_rotation(torch.from_numpy(R)).numpy()

        n = len(self.viewdirs)
        out = self.viewdirs.copy()
        a0 = self.anchors[0] if self.anchors else 0
        known = {a0: projection.rotation_matrix(torch.from_numpy(out[a0])).numpy()}
        for i in range(a0 + 1, n):
            m = pair_map.get((i - 1, i))
            known[i] = known[i - 1] if m is None else relative(m, known[i - 1], forward=True)
            out[i] = viewdir(known[i])
        for i in range(a0 - 1, -1, -1):
            m = pair_map.get((i, i + 1))
            known[i] = known[i + 1] if m is None else relative(m, known[i + 1], forward=False)
            out[i] = viewdir(known[i])
        return out

    def _blocks(self):
        """Matches as per-pair blocks padded to a common width K (a multiple
        of 128): xa, xb (P, K, 3), weights (P, K), image indices ia, ib (P,).

        Every row, padding included, carries the homogeneous 1: a zero row
        would put the ray norm's backward pass at 0 and the gradient at NaN,
        even under a zero weight.
        """
        coo = _coo(self.matches)
        blocks = [(m.xys[0], m.xys[1], int(i), int(j)) for m, i, j in zip(coo.data, coo.row, coo.col) if m.size > 0]
        P = len(blocks)
        K = -(-max(len(b[0]) for b in blocks) // 128) * 128
        xa = np.zeros((P, K, 3), np.float32)
        xb = np.zeros((P, K, 3), np.float32)
        xa[..., 2] = 1.0
        xb[..., 2] = 1.0
        w = np.zeros((P, K), np.float32)
        for p, (a, b, _, _) in enumerate(blocks):
            xa[p, : len(a), :2] = a
            xb[p, : len(a), :2] = b
            w[p, : len(a)] = 1.0
        ia = np.array([b[2] for b in blocks])
        ib = np.array([b[3] for b in blocks])
        return tuple(torch.from_numpy(v).to(self.device) for v in (xa, xb, w, ia, ib))

    def objective(self, free: np.ndarray, smooth: float = 1e-5):
        """The fit's objective as a function of the free images' view
        directions, flat (3 * len(free),) float32 on the device: the sum over
        matches of sqrt(r^2 + smooth^2) (|r| for ``smooth=0``), r each
        component of the difference of the two unit world rays."""
        xa, xb, w, ia, ib = self._blocks()
        viewdirs_0 = torch.from_numpy(self.viewdirs.astype(np.float32)).to(self.device)
        free_t = torch.from_numpy(np.asarray(free)).to(self.device)
        eps2 = float(smooth) ** 2

        def unit_rays(xys, R):
            d = torch.matmul(xys, R)
            return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-20)

        def value(flat):
            viewdirs = viewdirs_0.index_put((free_t,), flat.reshape(-1, 3))
            R = projection.rotation_matrix(viewdirs)
            with full_float32():
                r = unit_rays(xa, R[ia]) - unit_rays(xb, R[ib])
            term = torch.sqrt(r * r + eps2) if eps2 > 0.0 else torch.abs(r)
            return torch.sum(w[..., None] * term)

        return value

    def fit(self, anchor_weight: float = 1e6, method: str = "lbfgs-device", tol: Optional[float] = None,
            init: str = "chain", smooth: float = 1e-5, **kwargs):
        """View directions that minimize the ray objective.

        ``init="chain"`` starts from :meth:`initialize`, ``"current"`` from
        the images' view directions. Anchors are held exactly fixed
        (``anchor_weight`` is accepted for the reference's signature). The
        objective is a smoothed L1, ``sqrt(r^2 + smooth^2)``. ``method``:
        ``"lbfgs-device"`` (default, see :meth:`_fit_lbfgs_device`), or a
        ``scipy.optimize.minimize`` method driven from the host with the
        device's value and gradient: ``"l-bfgs-b"`` (stopping on the
        gradient, memory 30, 2,000 iterations), ``"bfgs"``, or
        ``"newton-cg"`` with Hessian-vector products from ``torch.func.jvp``
        of the gradient.

        Returns a ``scipy.optimize.OptimizeResult`` whose ``x`` holds every
        image's view direction (anchors included), flat.
        """
        n_imgs = len(self.viewdirs)
        free = np.setdiff1d(np.arange(n_imgs), np.asarray(self.anchors, dtype=int))
        value = self.objective(free, smooth)
        x0 = np.asarray(self.initialize() if init == "chain" else self.viewdirs)[free].ravel()
        if method.lower() == "lbfgs-device":
            return self._fit_lbfgs_device(value, x0, free, kwargs)

        def tensor(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

        def fun(x):
            flat = tensor(x).requires_grad_(True)
            v = value(flat)
            (g,) = torch.autograd.grad(v, flat)
            return v.item(), g.cpu().numpy().astype(float)

        options = dict(kwargs)
        if method.lower() == "l-bfgs-b":
            # The smoothing floor adds about n_matches * smooth to the value,
            # so scipy's relative ftol would stop on the first flat step;
            # stop on the gradient instead.
            defaults = {"ftol": 1e-14, "gtol": 1e-7, "maxcor": 30, "maxiter": 2000}
            options["options"] = {**defaults, **options.get("options", {})}
        if method.lower() in ("newton-cg", "trust-ncg", "trust-krylov"):
            grad = torch.func.grad(value)
            options["hessp"] = lambda x, v: (
                torch.func.jvp(grad, (tensor(x),), (tensor(v),))[1].cpu().numpy().astype(float)
            )
        result = scipy.optimize.minimize(fun=fun, x0=x0, jac=True, method=method, tol=tol, **options)
        full = self.viewdirs.copy()
        full[free] = np.asarray(result.x, dtype=float).reshape(-1, 3)
        result.x = full.ravel()
        self.reset_cameras()
        return result

    def _fit_lbfgs_device(self, value, x0, free, kwargs):
        """L-BFGS with the objective and the iterates on the device: the
        reference's ``optax.lbfgs(memory_size)`` loop (:func:`lbfgs`), memory
        ``memory_size`` (30), at most ``maxiter`` (2,000) iterations,
        stopping once ``|g|_2 < gtol`` (1e-7; in float32 the gradient of a
        sum over millions of matches floors far above it, so the budget is
        the expected stop)."""
        max_iter = int(kwargs.pop("maxiter", 2000))
        gtol = float(kwargs.pop("gtol", 1e-7))
        memory = int(kwargs.pop("memory_size", 30))

        def value_and_grad(flat):
            flat = flat.detach().requires_grad_(True)
            v = value(flat)
            (g,) = torch.autograd.grad(v, flat)
            return v.detach(), g

        x0 = torch.as_tensor(np.asarray(x0, dtype=np.float32), device=self.device)
        x, fval, grad, n_iter = lbfgs(value_and_grad, x0, max_iter=max_iter, gtol=gtol, memory=memory)
        gnorm = float(torch.linalg.vector_norm(grad))
        full = self.viewdirs.copy()
        full[free] = x.cpu().numpy().astype(float).reshape(-1, 3)
        result = scipy.optimize.OptimizeResult(
            x=full.ravel(), fun=fval, nit=n_iter, success=bool(np.isfinite(fval)), grad_norm=gnorm,
            message=(
                "device L-BFGS converged (|g| < gtol)" if gnorm < gtol
                else f"device L-BFGS iteration budget spent (|g| = {gnorm:.3e})" if n_iter >= max_iter
                else f"device L-BFGS stopped: line searches fail, the objective is flat to rounding (|g| = {gnorm:.3e})"
            ),
        )
        self.reset_cameras()
        return result


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (optax's and scipy's form)."""
    with np.errstate(all="ignore"):
        db, dc = np.float64(b - a), np.float64(c - a)
        denom = (db * dc) ** 2 * (db - dc)
        u, v = fb - fa - fpa * db, fc - fa - fpa * dc
        A = (dc**2 * u - db**2 * v) / denom
        B = (-(dc**3) * u + db**3 * v) / denom
        return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        B = (fb - fa - fpa * np.float64(b - a)) / np.float64(b - a) ** 2
        return a - fpa / (2.0 * B)


# optax.lbfgs's line search: scale_by_zoom_linesearch(max_linesearch_steps=
# 20, initial_guess_strategy="one") with its default tolerances.
_LS_STEPS = 20
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
# lbfgs stops once this many of the last 2 * _STALL line searches failed.
_STALL = 20


def _zoom_linesearch(value_and_grad, x, u, value0: float, grad0):
    """optax's zoom line search on the line ``x + t u``: a stepsize meeting
    the strong Wolfe conditions, with Hager and Zhang's approximate
    sufficient decrease (which a float32 objective near its optimum needs),
    found by doubling the step from 1 and then zooming by cubic, quadratic
    or bisection steps. After 20 evaluations, or once the interval is
    shorter than 1e-5, it falls back to the best step with sufficient
    decrease, as optax does. Returns (stepsize, value, gradient, whether the
    conditions were met) at the step.

    Only the objective and its gradient run on the device; the scalars of
    the search are read once an evaluation and kept in float64.
    """
    slope0 = float(torch.dot(u, grad0))

    def evaluate(t):
        value, grad = value_and_grad(x + t * u)
        v, s = torch.stack([value, torch.dot(grad, u)]).tolist()
        return v, grad, s

    def errors(t, v, s):
        """Sufficient-decrease and curvature errors, 0 where met; NaN is inf."""
        decrease = v - value0 - _SLOPE_RTOL * t * slope0
        approx = np.maximum(s - (2 * _SLOPE_RTOL - 1.0) * slope0, v - value0 - _APPROX_DEC_RTOL * abs(value0))
        decrease = np.maximum(np.minimum(approx, decrease), 0.0)
        curvature = np.maximum(abs(s) - _CURV_RTOL * abs(slope0), 0.0)
        return tuple(math.inf if math.isnan(e) else float(e) for e in (decrease, curvature))

    t, v, g, s = 0.0, value0, grad0, slope0
    low, v_low, s_low = 0.0, value0, slope0
    high, v_high = 0.0, value0
    cubic_ref, v_cubic_ref = 0.0, value0
    safe = (0.0, value0, grad0)
    decrease = math.inf
    found = False
    for count in range(_LS_STEPS):
        if not found:  # grow the step until an interval brackets a minimum
            prev_t, prev_v, prev_s = t, v, s
            t = 1.0 if count == 0 else 2.0 * prev_t
            v, g, s = evaluate(t)
            decrease, curvature = errors(t, v, s)
            if decrease <= 0.0:
                safe = (t, v, g)
            to_high = decrease > 0.0 or (v >= prev_v and count > 0)
            to_low = s >= 0.0 and not to_high
            if to_low:
                low, v_low, s_low, high, v_high = t, v, s, prev_t, prev_v
            else:
                low, v_low, s_low, high, v_high = prev_t, prev_v, prev_s, t, v
            cubic_ref, v_cubic_ref = low, v_low
            if max(decrease, curvature) <= 0.0:
                return t, v, g, True
            found = to_high or to_low
            too_small = False
        else:  # zoom into [low, high]
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            too_small = delta <= _INTERVAL_THRESHOLD
            middle = _cubicmin(low, v_low, s_low, high, v_high, cubic_ref, v_cubic_ref)
            if not left + 0.2 * delta < middle < right - 0.2 * delta:
                middle = _quadmin(low, v_low, s_low, high, v_high)
                if not left + 0.1 * delta < middle < right - 0.1 * delta:
                    middle = (low + high) / 2.0
            t = float(middle)
            v, g, s = evaluate(t)
            decrease, curvature = errors(t, v, s)
            if decrease <= 0.0 and v < safe[1]:
                safe = (t, v, g)
            if max(decrease, curvature) <= 0.0:
                return t, v, g, True
            to_high = decrease > 0.0 or v >= v_low
            high_to_low = s * (high - low) >= 0.0 and not to_high
            # The cubic's third point is the end point the new one replaces.
            cubic_ref, v_cubic_ref = (high, v_high) if to_high or high_to_low else (low, v_low)
            if to_high:
                high, v_high = t, v
            elif high_to_low:
                high, v_high = low, v_low
            if not to_high:
                low, v_low, s_low = t, v, s
        if too_small and safe[0] > 0.0:
            break
    if safe[0] > 0.0 or math.isinf(decrease):
        return (*safe, False)
    return t, v, g, False


def lbfgs(value_and_grad, x0, max_iter: int = 2000, gtol: float = 1e-7, memory: int = 30):
    """Minimize with ``optax.lbfgs(memory_size=memory)`` semantics: the
    two-loop recursion over the last ``memory`` (step, gradient change)
    pairs, the identity scaled by ``s.y / y.y`` (by ``min(1, 1 / |g|)`` on the
    first step), and :func:`_zoom_linesearch` from a unit step; iterations
    continue while ``|g|_2 >= gtol``, fewer than ``max_iter`` have run and
    fewer than 20 of the last 40 line searches have failed.

    ``value_and_grad(x) -> (value, gradient)`` as tensors on ``x0``'s device.
    Returns (x, value, gradient, iterations). Where it differs from the
    reference's jitted loop: it runs on the host, reading the card once per
    line-search evaluation; the search's scalars are float64 on the host
    (float32 on the device in optax); memory slots not yet written are
    skipped, which is exact (they carry zero weight); and the stop on failed
    line searches, which optax lacks: once the float32 objective is flat to its
    rounding, searches keep failing (every other one, say), each spending
    its 20 evaluations on a step of no measurable gain, and optax goes on
    doing so to ``max_iter``.
    """
    x = x0.detach().clone()
    value, grad = value_and_grad(x)
    value = float(value)
    S, Y, rho = [], [], []
    prev_x = prev_g = None
    n_iter = 0
    failed = collections.deque(maxlen=2 * _STALL)
    while n_iter == 0 or (n_iter < max_iter and sum(failed) < _STALL and float(torch.linalg.vector_norm(grad)) >= gtol):
        if prev_x is None:
            gamma = min(1.0, 1.0 / float(torch.linalg.vector_norm(grad)))
        else:
            s, y = x - prev_x, grad - prev_g
            sy, yy = torch.stack([torch.dot(y, s), torch.dot(y, y)]).tolist()
            S.append(s)
            Y.append(y)
            rho.append(0.0 if sy == 0.0 else 1.0 / sy)
            if len(S) > memory:
                del S[0], Y[0], rho[0]
            gamma = sy / yy if yy > 0.0 else 1.0
        q = grad.clone()
        alphas = []
        for s_i, y_i, r_i in zip(reversed(S), reversed(Y), reversed(rho)):
            alpha = r_i * torch.dot(s_i, q)
            q = q - alpha * y_i
            alphas.append(alpha)
        q = gamma * q
        for s_i, y_i, r_i, alpha in zip(S, Y, rho, reversed(alphas)):
            q = q + (alpha - r_i * torch.dot(y_i, q)) * s_i
        prev_x, prev_g = x, grad
        t, value, grad, met = _zoom_linesearch(value_and_grad, x, -q, value, grad)
        failed.append(not met)
        x = x - t * q
        n_iter += 1
    return x, value, grad, n_iter


# cv2.SIFT_create keyword names the device detector accepts (values are
# translated, not emulated).
_DEVICE_DETECTOR_KWARGS = {
    "contrastThreshold": "contrast_threshold",
    "edgeThreshold": "edge_ratio",
    "sigma": "sigma0",
    "nOctaveLayers": "n_scales",
}


def detect_keypoints_device(arrays, masks=None, **kwargs):
    """Keypoints on the device (:func:`ops.features.detect_and_describe`);
    accepts the common ``cv2.SIFT_create`` keyword spellings. Returns
    ``(pts (n, 2), descriptors (n, 128))`` per image."""
    for cv2_name, ours in _DEVICE_DETECTOR_KWARGS.items():
        if cv2_name in kwargs:
            kwargs[ours] = kwargs.pop(cv2_name)
    return features.detect_and_describe(arrays, masks=masks, **kwargs)


def match_keypoints_device(ka, kb, cross_check: bool = False, max_ratio: float = None, max_distance: float = None,
                           return_ratios: bool = False, matcher=None):
    """Match two images' ``(keypoints, descriptors)`` on the device.

    ``matcher`` is a :class:`ops.matching.DescriptorMatcher` (a new one on
    the card when None). Returns ``(uva, uvb)``, plus the ratios with
    ``return_ratios``; ``max_distance`` drops matches at least that many
    pixels apart.
    """
    matcher = matcher or DescriptorMatcher()
    pairs, ratios = matcher.match(ka[1], kb[1], max_ratio=max_ratio, cross_check=cross_check)
    if not len(pairs):
        e = np.empty((0, 2), dtype=float)
        return (e, e.copy(), np.empty(0, dtype=float)) if return_ratios else (e, e.copy())
    uva = np.asarray(ka[0])[pairs[:, 0]]
    uvb = np.asarray(kb[0])[pairs[:, 1]]
    if max_distance:
        ok = np.linalg.norm(uva - uvb, axis=1) < max_distance
        uva, uvb, ratios = uva[ok], uvb[ok], ratios[ok]
    return (uva, uvb, ratios) if return_ratios else (uva, uvb)
