"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` file exposes a plain C interface and compiles on its
own into ``build/glimpse_tpu_torch/lib<name>-<digest>.so`` at the root of the
checkout, on the first call that needs it. The digest covers the source and
the flags, so an edited source builds anew and a stale library is never
loaded. Nothing here runs at import time: the CPU paths never need ``nvcc``.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    source = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its library exists, then load it.

    The compiler's output, with ``ptxas``'s register and shared-memory
    report, is kept beside the library as ``.log``. While
    :func:`profiling.enabled`, a load counts in ``kernels.loads``, and a
    build is the span ``kernels.build`` (``name`` its program) and counts
    in ``kernels.builds``.
    """
    lib = library_path(name)
    profiling.count("kernels.loads")
    if not lib.exists():
        profiling.count("kernels.builds")
        with profiling.span("kernels.build", program=name):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {name}.cu ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        lib.glimpse_error_string.restype = ctypes.c_char_p
        lib.glimpse_error_string.argtypes = [ctypes.c_int]
        message = lib.glimpse_error_string(code).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {code} ({message})")
