"""Native (C++) host feeder functions, bound via ctypes.

Multithreaded host-side image preparation feeding the device pipeline:
grayscale conversion, tile gathering, normalization, and median high-pass.
``src/feeder.cpp`` is built with ``g++`` at first use into
``build/glimpse_tpu_torch/libglimpse_feeder-<digest>.so`` at the root of the
checkout (the digest covers the source and the flags). Every entry point has
a NumPy path, so the package works on a host without a compiler;
:func:`backend` says which one runs, and ``load(required=True)`` raises
instead of falling back.
"""
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "feeder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glimpse_tpu_torch"
# No -march=native: a checkout's build directory may be seen by hosts with
# other CPUs, and the digest below does not know the host.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def library_path() -> Path:
    """Where the library built from ``src/feeder.cpp`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libglimpse_feeder-{digest}.so"


class _BuildError(RuntimeError):
    """The compiler is missing or refused the source: no retry will help."""


def _build(lib: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise _BuildError("no C++ compiler (g++) on this host")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise _BuildError(f"{cxx} failed on feeder.cpp ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)


def _open_built() -> ctypes.CDLL:
    """Build (once across processes) and open the library.

    Processes that start at the same moment (test workers, a card's chip
    run) serialize on an exclusive lock in ``BUILD_DIR``: the first builds,
    the others find the finished file once the lock is theirs.
    """
    path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{path.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _build(path)
        try:
            return ctypes.CDLL(str(path))
        except OSError as e:
            raise _BuildError(f"cannot load {path}: {e}") from e


def load(required: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the feeder library.

    Returns None when it cannot be built or loaded, after a warning, so
    callers take their NumPy path; with ``required`` that is an error that
    carries the failure's own text. Only a compiler's refusal or a complete
    file that does not load is remembered for the process; any other
    failure (a time limit, a file system error) is tried again next call.
    """
    global _lib, _load_error
    if _lib is None and _load_error is None:
        try:
            lib = _open_built()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            error = f"{type(e).__name__}: {e}"
            if isinstance(e, _BuildError):
                _load_error = error
            warnings.warn(f"glimpse_tpu_torch native feeder unavailable, using NumPy: {error}")
            if required:
                raise RuntimeError(f"native feeder library unavailable: {error}") from e
            return None
        else:
            i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
            f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
            cint = ctypes.c_int
            lib.gray_f32.argtypes = [u8p, i64, i64, i64, f32p, cint]
            lib.extract_tiles_f32.argtypes = [f32p, i64, i64, i32p, i64, i64, i64, f32p, cint]
            lib.normalize_tiles_f32.argtypes = [f32p, i64, i64, cint]
            lib.median_highpass_f32.argtypes = [f32p, i64, i64, i64, i64, i64, f32p, cint]
            _lib = lib
    if _lib is None and required:
        raise RuntimeError(f"native feeder library unavailable: {_load_error}")
    return _lib


def backend() -> str:
    """``"native"`` when the C++ library serves the entry points, else ``"numpy"``."""
    return "native" if load() is not None else "numpy"


def available() -> bool:
    """Whether the native library is loadable."""
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gray_f32(image: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """uint8 (H, W[, C]) -> grayscale float32 (H, W) (channel mean)."""
    lib = load()
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    H, W, C = image.shape
    if lib is None or image.dtype != np.uint8:
        return np.asarray(image, dtype=np.float32).mean(axis=2)
    out = np.empty((H, W), dtype=np.float32)
    lib.gray_f32(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        H, W, C, _f32p(out), nthreads,
    )
    return out


def extract_tiles_f32(
    image: np.ndarray, corners: np.ndarray, size, nthreads: int = 0
) -> np.ndarray:
    """Gather fixed-size tiles at integer (row, col) corners (clamped)."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.float32)
    corners = np.ascontiguousarray(corners, dtype=np.int32)
    th, tw = int(size[0]), int(size[1])
    n = len(corners)
    H, W = image.shape
    if lib is None:
        out = np.empty((n, th, tw), dtype=np.float32)
        for i, (r0, c0) in enumerate(corners):
            r0 = min(max(int(r0), 0), H - th)
            c0 = min(max(int(c0), 0), W - tw)
            out[i] = image[r0 : r0 + th, c0 : c0 + tw]
        return out
    out = np.empty((n, th, tw), dtype=np.float32)
    lib.extract_tiles_f32(
        _f32p(image), H, W,
        corners.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, th, tw, _f32p(out), nthreads,
    )
    return out


def normalize_tiles_f32(tiles: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """In-place mean-0/std-1 normalization of stacked tiles (n, h, w)."""
    lib = load()
    tiles = np.ascontiguousarray(tiles, dtype=np.float32)
    n = tiles.shape[0]
    size = int(np.prod(tiles.shape[1:]))
    if lib is None:
        mean = tiles.reshape(n, -1).mean(axis=1)[:, None, None]
        std = tiles.reshape(n, -1).std(axis=1)[:, None, None]
        return ((tiles - mean) / np.where(std > 0, std, 1)).astype(np.float32)
    lib.normalize_tiles_f32(_f32p(tiles), n, size, nthreads)
    return tiles


def median_highpass_f32(tiles: np.ndarray, size=(5, 5), nthreads: int = 0) -> np.ndarray:
    """Median high-pass (reflect boundary) over stacked tiles (n, h, w)."""
    lib = load()
    tiles = np.ascontiguousarray(tiles, dtype=np.float32)
    squeeze = tiles.ndim == 2
    if squeeze:
        tiles = tiles[None]
    n, H, W = tiles.shape
    if lib is None:
        import scipy.ndimage

        out = np.stack(
            [t - scipy.ndimage.median_filter(t, size=size) for t in tiles]
        ).astype(np.float32)
    else:
        out = np.empty_like(tiles)
        lib.median_highpass_f32(
            _f32p(tiles), n, H, W, int(size[0]), int(size[1]), _f32p(out), nthreads
        )
    return out[0] if squeeze else out
