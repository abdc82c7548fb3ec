"""The seam every CUDA kernel of the port goes through (``kernels/_build.py``):
each source in ``csrc/`` has one registered wrapper, whose C signature is the
source's own, whose counts ``profiling.report()`` gives, and whose library a
variant source builds beside, never over. Runs on the CPU: nothing is
compiled.
"""
import hashlib
import re

import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu_torch import profiling
from glimpse_tpu_torch.kernels import _build

SOURCES = sorted(_build.SOURCE_DIR.glob("*.cu"))
#: The element types by their names in a source's ``enum Dtype``.
ENUM_TYPES = {"kFloat32": torch.float32, "kFloat64": torch.float64, "kFloat16": torch.float16,
              "kBFloat16": torch.bfloat16}


def _parameters(text: str, symbol: str) -> int:
    """How many parameters the C entry ``symbol`` of a source's text takes."""
    match = re.search(rf'extern "C" [^;{{]*?\b{symbol}\(([^)]*)\)', text)
    assert match is not None, f"{symbol} is not exported"
    return len(match.group(1).split(","))


@pytest.mark.parametrize("source", SOURCES, ids=[s.stem for s in SOURCES])
def test_each_source_has_one_registered_wrapper(source, tmp_path) -> None:
    """One wrapper registers the source's library; its entries' argument
    counts are the source's, its element-type codes its ``enum Dtype``;
    ``report()`` carries its two counts; and a copy of the source outside
    ``csrc/`` builds into the bench directory under its own digest."""
    kernels = [k for k in _build.KERNELS.values() if k.label == source.stem]
    assert len(kernels) == 1
    kernel = kernels[0]
    assert isinstance(kernel.wrapper.launches, int) and isinstance(kernel.wrapper.captured, int)
    text = source.read_text()
    assert _parameters(text, kernel.symbol) == len(kernel.argtypes)
    for symbol, (_, argtypes) in kernel.entries.items():
        assert _parameters(text, symbol) == len(argtypes), symbol
    dtype = re.search(r"enum Dtype \{([^}]*)\}", text)
    if dtype is not None:
        codes = {ENUM_TYPES[name]: int(value) for name, value in re.findall(r"(k\w+) = (\d+)", dtype.group(1))}
        assert codes == _build.DTYPE_CODES
    counters = profiling.report()["counters"]
    assert counters[f"kernel.{kernel.label}.launches"] == kernel.wrapper.launches
    assert counters[f"kernel.{kernel.label}.captured"] == kernel.wrapper.captured
    digest = hashlib.sha256(source.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert _build.library_path(source.stem) == _build.BUILD_DIR / f"lib{source.stem}-{digest}.so"
    assert _build.library_path(source.stem, source) == _build.library_path(source.stem)
    variant = tmp_path / f"{source.stem}_variant.cu"
    variant.write_bytes(source.read_bytes() + b"\n")
    digest = hashlib.sha256(variant.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert _build.library_path(source.stem, variant) == (
        _build.BUILD_DIR / "bench" / f"lib{source.stem}_variant-{digest}.so")
