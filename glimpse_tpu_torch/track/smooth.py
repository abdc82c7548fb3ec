"""Fixed-interval (RTS) smoothing of particle-filter moment trajectories.

The tracking motion models (``CartesianMotion`` and its batched twin) have
*linear-Gaussian* dynamics — position integrates velocity, velocity random-
walks with acceleration noise — only the image observation is non-Gaussian.
The particle filter therefore produces per-frame Gaussian approximations
(mean, covariance) whose dynamics-side information can be propagated
backwards exactly: a Rauch-Tung-Striebel pass over the filtered moments.
Smoothing uses future observations to refine past states and typically
halves the steady-state error of the filter-only trajectory.

The counterpart of :mod:`glimpse_tpu.track.smooth`, an extension over
upstream (which offers only forward/backward *refiltering* and fusion); it
composes with the device
:class:`~glimpse_tpu_torch.track.batch.BatchTracker`
(``BatchConfig(return_covariances=True)``).
"""
from typing import Tuple

import numpy as np

__all__ = ["transition_matrix", "process_noise", "rts_smooth"]


def transition_matrix(dt: float) -> np.ndarray:
    """Constant-velocity transition over the 6-state (xyz, vxyz)."""
    F = np.eye(6)
    F[0:3, 3:6] = dt * np.eye(3)
    return F


def process_noise(dt: float, a_sigma) -> np.ndarray:
    """Covariance of the random-acceleration increment over one step.

    The motion models perturb each axis with ``a ~ N(0, a_sigma^2)`` applied
    as ``dx += a dt^2 / 2`` and ``dv += a dt`` (motion.py:115-120), so the
    increment covariance per axis is the standard white-acceleration block
    ``sigma^2 [[dt^4/4, dt^3/2], [dt^3/2, dt^2]]``.
    """
    a_var = np.asarray(a_sigma, dtype=float) ** 2  # (3,) or scalar
    a_var = np.broadcast_to(a_var, (3,))
    Q = np.zeros((6, 6))
    for axis in range(3):
        Q[axis, axis] = a_var[axis] * dt ** 4 / 4
        Q[axis, 3 + axis] = Q[3 + axis, axis] = a_var[axis] * dt ** 3 / 2
        Q[3 + axis, 3 + axis] = a_var[axis] * dt ** 2
    return Q


def rts_smooth(
    means: np.ndarray,
    covariances: np.ndarray,
    dts,
    a_sigma,
    jitter: float = 1e-9,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rauch-Tung-Striebel smoothing of filtered trajectories.

    Arguments:
        means: Filtered means (T, N, 6) — time-major, batched over tracks.
        covariances: Filtered covariances (T, N, 6, 6).
        dts: Time steps (T-1,) in motion time units.
        a_sigma: Acceleration noise, scalar or per-axis (3,) or per-track
            (N, 3) — the motion model's ``a_sigma``.
        jitter: Diagonal regularization for degenerate axes (e.g. frozen z).

    Returns:
        (smoothed means (T, N, 6), smoothed covariances (T, N, 6, 6)).
    """
    means = np.asarray(means, dtype=float)
    covariances = np.asarray(covariances, dtype=float)
    T, N, D = means.shape
    dts = np.broadcast_to(np.asarray(dts, dtype=float), (T - 1,))
    a_sigma = np.asarray(a_sigma, dtype=float)
    per_track = a_sigma.ndim == 2

    sm = means.copy()
    sc = covariances.copy()
    eye = np.eye(D)
    for t in range(T - 2, -1, -1):
        dt = float(dts[t])
        F = transition_matrix(dt)
        if per_track:
            Q = np.stack([process_noise(dt, a) for a in a_sigma])  # (N, 6, 6)
        else:
            Q = process_noise(dt, a_sigma)[None]  # (1, 6, 6)
        P = covariances[t]  # (N, 6, 6)
        pred_mean = means[t] @ F.T  # (N, 6)
        PFt = P @ F.T  # (N, 6, 6)
        pred_cov = F @ PFt + Q + jitter * eye  # (N, 6, 6)
        # Gain G = P F' pred_cov^{-1}  (solve on the transposed system).
        G = np.linalg.solve(
            np.swapaxes(pred_cov, -1, -2), np.swapaxes(PFt, -1, -2)
        )
        G = np.swapaxes(G, -1, -2)
        innov = sm[t + 1] - pred_mean  # (N, 6)
        sm[t] = means[t] + np.einsum("nij,nj->ni", G, innov)
        dP = sc[t + 1] - pred_cov
        sc[t] = P + G @ dP @ np.swapaxes(G, -1, -2)
    return sm, sc
