"""Checkpoint and resume of the batched tracker's state.

A snapshot is an ``.npz`` file holding every field of a
:class:`~glimpse_tpu_torch.track.batch.BatchState`, with the generator's
state (``torch.Generator.get_state()``) and its device type in place of the
reference's PRNG key data. Resuming on the device type the snapshot was
taken on continues bit for bit.

The state of a tracker on a mesh
(:class:`~glimpse_tpu_torch.parallel.tracker.MeshState`) is saved slice by
slice: each slice's rows, its generator's state and its device, under
``part<k>_`` keys. It resumes bit for bit on a mesh of the same devices: by
default the saved ones, or ``device=`` a mesh (or sequence) of as many
devices of the same types.

Every array keeps its dtype. NumPy has no bfloat16, so a 16-bit array
(bfloat16 or float16) is saved as its raw ``uint16`` bits beside a tag
``<name>_dtype`` and restored bit for bit. Version 1 snapshots, float32
throughout and without tags, still load.

The formats are the port's own: ``format`` names each and
``format_version`` counts its changes. A snapshot of the reference package
(``glimpse_tpu.track.checkpoint``) holds a PRNG key and is refused.
"""
from pathlib import Path
from typing import Union

import numpy as np
import torch

from .batch import BatchState

FORMAT = "glimpse_tpu_torch.BatchState"
MESH_FORMAT = "glimpse_tpu_torch.MeshState"
#: Bump whenever a BatchState field is added or changes meaning. Version 2
#: tags 16-bit arrays; :func:`load_state` reads every version listed in
#: ``READS``.
FORMAT_VERSION = 2
READS = (1, 2)

_ARRAYS = ("particles", "weights", "templates", "template_table", "template_duv", "valid")
_SIXTEEN_BITS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _array(tensor: torch.Tensor, name: str) -> dict:
    """Snapshot entries of one tensor: the array itself, or for a 16-bit one
    its ``uint16`` bits and a ``<name>_dtype`` tag."""
    tensor = tensor.detach().cpu()
    tag = str(tensor.dtype).removeprefix("torch.")
    if tag in _SIXTEEN_BITS:
        return {name: tensor.view(torch.uint16).numpy(), f"{name}_dtype": np.asarray(tag)}
    return {name: tensor.numpy()}


def _tensor(data, name: str) -> torch.Tensor:
    """The tensor :func:`_array` saved under ``name``, bit for bit."""
    array = torch.from_numpy(data[name].copy())
    if f"{name}_dtype" in data:
        return array.view(_SIXTEEN_BITS[str(data[f"{name}_dtype"])])
    return array


def _fields(state: BatchState, prefix: str = "") -> dict:
    """A state's arrays, step and generator as snapshot entries."""
    arrays = {}
    for k in _ARRAYS:
        arrays.update(_array(getattr(state, k), prefix + k))
    arrays[prefix + "generator_state"] = state.generator.get_state().numpy()
    arrays[prefix + "generator_device"] = np.asarray(str(state.generator.device))
    return arrays


def save_state(state, path: Union[str, Path]) -> None:
    """Write a ``BatchState``, or a mesh's ``MeshState``, to an ``.npz``
    file (waits for the device)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(state, BatchState):
        fields = _fields(state)
        fields["generator_device"] = np.asarray(state.generator.device.type)
        header = dict(format=np.asarray(FORMAT))
    else:
        fields = {}
        for k, part in enumerate(state.parts):
            fields.update(_fields(part, f"part{k}_"))
        header = dict(format=np.asarray(MESH_FORMAT), n_parts=np.asarray(len(state.parts)))
    np.savez_compressed(path, **header, format_version=np.asarray(FORMAT_VERSION), step=np.asarray(state.step),
                        **fields)


def _load(data, prefix: str, step: int, device) -> BatchState:
    """The BatchState under ``prefix`` on ``device``, refused on a device of
    another type than its generator's."""
    saved = torch.device(str(data[prefix + "generator_device"]))
    device = saved if device is None else torch.device(device)
    if device.type != saved.type:
        raise ValueError(f"a {saved.type} generator's state cannot resume on {device}")
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(data[prefix + "generator_state"].copy()))
    return BatchState(
        generator=generator, step=step,
        **{k: _tensor(data, prefix + k).to(device) for k in _ARRAYS},
    )


def load_state(path: Union[str, Path], device=None):
    """Read a snapshot written by :func:`save_state`.

    A ``BatchState``: ``device`` defaults to the device type its generator
    was saved on. A ``MeshState``: ``device`` defaults to each slice's saved
    device, or is a mesh (or sequence) with one device a slice. A device of
    another type than the saved one is refused, since a generator's state
    does not carry across device types.
    """
    from ..parallel.tracker import MeshState

    with np.load(Path(path)) as data:
        if "key_data" in data:
            raise ValueError(
                f"{path} is a snapshot of the JAX package (it holds a PRNG key); carry its"
                " arrays across with glimpse_tpu_torch.track.convert.state_from_numpy"
            )
        kind = str(data["format"]) if "format" in data else None
        if kind not in (FORMAT, MESH_FORMAT):
            raise ValueError(f"{path} is not a {FORMAT} or {MESH_FORMAT} snapshot")
        version = int(data["format_version"])
        if version not in READS:
            raise ValueError(f"{path} has format_version={version}; this package reads {READS}")
        step = int(data["step"])
        try:
            if kind == FORMAT:
                return _load(data, "", step, device)
            n_parts = int(data["n_parts"])
            devices = [None] * n_parts if device is None else list(device)
            if len(devices) != n_parts:
                raise ValueError(f"{path} holds {n_parts} mesh slices; got {len(devices)} devices")
            return MeshState([_load(data, f"part{k}_", step, d) for k, d in enumerate(devices)])
        except ValueError as error:
            raise ValueError(f"{path}: {error}") from None
