"""Build the port's CUDA sources with nvcc, load them with ctypes, and launch
and count the kernels in them: the one seam every kernel goes through.

Each ``csrc/<name>.cu`` file exposes a plain C interface and compiles on its
own into ``build/glimpse_tpu_torch/lib<name>-<digest>.so`` at the root of the
checkout, on the first call that needs it; a source from elsewhere (a
variant a bench script times beside the checkout's) builds with the same
flags into ``build/glimpse_tpu_torch/bench/lib<stem>-<digest>.so``. The
digest covers the source and the flags, so an edited source builds anew and
a stale library is never loaded. Nothing here runs at import time: the CPU
paths never need ``nvcc``.

Each kernel wrapper registers itself at import (:func:`kernel`) under its
library's name, with its launch entry and that entry's C signature, in
:data:`KERNELS`. The wrapper runs its plain version on a CPU tensor and its
kernel on a CUDA tensor (:func:`runs_kernel`), and launches through
:func:`launch`, which counts: ``wrapper.launches`` counts the kernel's
launches, and a call made while its stream is being captured into a CUDA
graph launches nothing and adds to ``wrapper.captured`` instead.
:class:`glimpse_tpu_torch.graphs.Graph` reads every registered kernel's
``captured`` around its capture and adds the difference to ``launches`` at
each replay, and :func:`glimpse_tpu_torch.profiling.report` gives each as
``kernel.<label>.launches`` and ``kernel.<label>.captured``. A new kernel is
a source in ``csrc/`` and a wrapper that registers; nothing else lists it.
"""
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from .. import profiling

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glimpse_tpu_torch"
# --split-compile=0 optimizes the device code in parallel on every core: the
# high-pass library's 64 kernels build in about 30 s instead of 96, to the
# same SASS instruction for instruction (cuobjdump, CUDA 12.8, sm_90a).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--split-compile=0",
)
#: The element types the kernels take, by the code each source's ``enum
#: Dtype`` gives them.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A registered kernel: its label, the name of the library
    ``csrc/<label>.cu`` builds; the wrapper that launches it and counts its
    launches; the launch entry ``symbol`` with its ``argtypes`` (the stream
    last; it returns a CUDA error code); and the library's other entries as
    ``{symbol: (restype, argtypes)}``."""

    label: str
    wrapper: Callable
    symbol: str
    argtypes: tuple
    entries: Mapping[str, tuple]


#: The registered kernels by label, in the order their wrappers were imported.
KERNELS: Dict[str, Kernel] = {}


def kernel(label: str, symbol: str, argtypes: Sequence, entries: Optional[Mapping[str, tuple]] = None) -> Callable:
    """Register the decorated wrapper as the kernel ``label``, launched by
    ``symbol`` of the library ``csrc/<label>.cu`` builds, and set its
    ``launches`` and ``captured`` to 0."""

    def register(wrapper: Callable) -> Callable:
        wrapper.launches = 0
        wrapper.captured = 0
        KERNELS[label] = Kernel(label, wrapper, symbol, tuple(argtypes), dict(entries or {}))
        return wrapper

    return register


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of glimpse_tpu_torch are built"
            " on first use and need the CUDA toolkit"
        )
    return found


def library_path(name: str, source: Optional[Path] = None) -> Path:
    """Where the library built from ``source`` lives: ``csrc/<name>.cu`` by
    default, built into :data:`BUILD_DIR`; a source outside ``csrc/`` is
    built into its ``bench`` directory."""
    source = Path(source) if source is not None else SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    home = BUILD_DIR if source.resolve().parent == SOURCE_DIR else BUILD_DIR / "bench"
    return home / f"lib{source.stem}-{digest}.so"


def load(name: str, source: Optional[Path] = None) -> ctypes.CDLL:
    """Build ``source`` (``csrc/<name>.cu`` by default) unless its library
    (:func:`library_path`) exists, then load it, once a process.

    The compiler's output, with ``ptxas``'s register and shared-memory
    report, is kept beside the library as ``.log``. While
    :func:`profiling.enabled`, a load counts in ``kernels.loads``, and a
    build is the span ``kernels.build`` (``name`` its program) and counts
    in ``kernels.builds``.
    """
    return _load(name, Path(source).resolve() if source is not None else SOURCE_DIR / f"{name}.cu")


@functools.cache
def _load(name: str, source: Path) -> ctypes.CDLL:
    lib = library_path(name, source)
    profiling.count("kernels.loads")
    if not lib.exists():
        profiling.count("kernels.builds")
        with profiling.span("kernels.build", program=name):
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


@functools.cache
def entry(label: str, symbol: Optional[str] = None, source: Optional[Path] = None):
    """The C entry ``symbol`` (the launch entry by default) of the kernel
    ``label``'s library, built from ``source`` (as :func:`load`), with the
    signature its registration gives."""
    spec = KERNELS[label]
    if symbol is None or symbol == spec.symbol:
        symbol, restype, argtypes = spec.symbol, ctypes.c_int, spec.argtypes
    else:
        restype, argtypes = spec.entries[symbol]
    fn = getattr(load(label, source), symbol)
    fn.restype, fn.argtypes = restype, list(argtypes)
    return fn


def runs_kernel(label: str, device: torch.device) -> bool:
    """Whether the kernel ``label``'s wrapper launches it for tensors on
    ``device``: True on a CUDA card, False on the CPU (the plain version
    runs); ValueError on any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{KERNELS[label].wrapper.__name__} runs on cpu or cuda, got {device}")
    return True


def c_arguments(args) -> list:
    """``args`` with each tensor as its data pointer."""
    return [arg.data_ptr() if isinstance(arg, torch.Tensor) else arg for arg in args]


def launch(label: str, device: torch.device, *args) -> None:
    """Call the kernel ``label``'s launch entry on ``args`` (a tensor for
    each pointer) and the current stream of ``device``, and raise if it
    returned a CUDA error. Counts the call in the wrapper's ``captured``
    while that stream is being captured into a CUDA graph, else in its
    ``launches``."""
    spec = KERNELS[label]
    with torch.cuda.device(device):
        code = entry(label)(*c_arguments(args), torch.cuda.current_stream().cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if code != 0:
        lib = load(label)
        lib.glimpse_error_string.restype = ctypes.c_char_p
        lib.glimpse_error_string.argtypes = [ctypes.c_int]
        message = lib.glimpse_error_string(code).decode()
        raise RuntimeError(f"{spec.wrapper.__name__} kernel failed: CUDA error {code} ({message})")
    if capturing:
        spec.wrapper.captured += 1
    else:
        spec.wrapper.launches += 1
