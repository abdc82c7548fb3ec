"""Checkpoint and resume of the batched tracker's state.

A snapshot is an ``.npz`` file holding every field of a
:class:`~glimpse_tpu_torch.track.batch.BatchState`, with the generator's
state (``torch.Generator.get_state()``) and its device type in place of the
reference's PRNG key data. Resuming on the device type the snapshot was
taken on continues bit for bit.

The format is the port's own: ``format`` names it and ``format_version``
counts its changes. A snapshot of the reference package
(``glimpse_tpu.track.checkpoint``) holds a PRNG key and is refused.
"""
from pathlib import Path
from typing import Union

import numpy as np
import torch

from .batch import BatchState

FORMAT = "glimpse_tpu_torch.BatchState"
#: Bump whenever a BatchState field is added or changes meaning.
FORMAT_VERSION = 1

_ARRAYS = ("particles", "weights", "templates", "template_table", "template_duv", "valid")


def save_state(state: BatchState, path: Union[str, Path]) -> None:
    """Write ``state`` to an ``.npz`` file (waits for the device)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: getattr(state, k).cpu().numpy() for k in _ARRAYS}
    np.savez_compressed(
        path,
        format=np.asarray(FORMAT),
        format_version=np.asarray(FORMAT_VERSION),
        step=np.asarray(state.step),
        generator_state=state.generator.get_state().numpy(),
        generator_device=np.asarray(state.generator.device.type),
        **arrays,
    )


def load_state(path: Union[str, Path], device=None) -> BatchState:
    """Read a snapshot written by :func:`save_state`.

    ``device`` defaults to the device type the generator was saved on; one
    of another type is refused, since a generator's state does not carry
    across device types.
    """
    with np.load(Path(path)) as data:
        if "key_data" in data:
            raise ValueError(
                f"{path} is a snapshot of the JAX package (it holds a PRNG key); carry its"
                " arrays across with glimpse_tpu_torch.track.convert.state_from_numpy"
            )
        if "format" not in data or str(data["format"]) != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} snapshot")
        version = int(data["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"{path} has format_version={version}; this package reads {FORMAT_VERSION}")
        saved = str(data["generator_device"])
        device = torch.device(saved if device is None else device)
        if device.type != saved:
            raise ValueError(f"{path} holds a {saved} generator's state; it cannot resume on {device}")
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(data["generator_state"].copy()))
        return BatchState(
            generator=generator,
            step=int(data["step"]),
            **{k: torch.from_numpy(data[k].copy()).to(device) for k in _ARRAYS},
        )
