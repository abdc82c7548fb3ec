"""The comparison that decides ``correct``.

A free-running particle filter parts from any other computation of itself
once a rounding moves a systematic-resampling threshold across a slot: from
then on the two follow different, equally likely particle paths, and their
means differ by the filter's own Monte Carlo noise. So the program's means
are held to the reference's tightly only where no resampling stands between
them, and for the rest of the run against the truth, as the reference's are:

- ``start_gap_px``: the largest |program - reference| of a sampled point's
  mean (x, y) at step 1, whose moments come before any resampling;
- ``early_gap_px``: over steps 1 to ``early_steps``, the largest
  ``quantile`` (a low quantile, so that the few points whose threshold
  flipped do not set it) over the sampled points of that gap;
- ``error_ratio``: the root-mean-square distance of the sampled points'
  last means from the truth, the program's over the reference's;
- ``lost_point_steps``: point-steps of the whole window whose mean is not
  finite or whose point was marked invalid (every point of these scenes
  stays visible, so none may be lost).

:func:`numbers` compares the runs of every configuration whose reference
brings no ``numbers`` of its own (:func:`portbench.cells.parts`); the rest of
this module serves them all.
"""
from typing import Dict

import numpy as np
import torch


def numbers(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], truth: np.ndarray,
            early_steps: int, quantile: float) -> Dict[str, float]:
    """The compared numbers of one tracking run at the sampled points:
    ``program`` and ``reference`` hold "mean" (T, S, 6), ``truth`` (T, S, 2)
    the true positions after each step."""
    got = program["mean"][..., 0:2].double().cpu()
    want = reference["mean"][..., 0:2].double().cpu()
    gap = (got - want).abs().amax(dim=-1)  # (T, S)
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    early = torch.quantile(gap[:early_steps], quantile, dim=1, interpolation="higher")
    truth = torch.as_tensor(truth[-1])

    def rms(means):
        return float(torch.sqrt(((means[-1] - truth) ** 2).sum(dim=-1).mean()))

    return {
        "start_gap_px": float(gap[0].max()),
        "early_gap_px": float(early.max()),
        "error_ratio": rms(got) / rms(want),
    }


def worst(readings) -> Dict[str, float]:
    """Each number's largest reading over several checked runs."""
    out: Dict[str, float] = {}
    for reading in readings:
        for name, value in reading.items():
            out[name] = max(out.get(name, -np.inf), value)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(bool(np.isfinite(readings[name])) and readings[name] <= limit for name, limit in limits.items())
