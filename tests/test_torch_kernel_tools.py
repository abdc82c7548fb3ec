"""The high-pass kernel's measuring tools, on the host.

``kernels/sass.py`` reads ``cuobjdump -sass`` and ptxas's report, and
``kernels/bench_highpass.py`` names the cases it times on the card. Neither
needs a card to be read: here a SASS listing written by hand stands in for
``cuobjdump``'s, so the counts a chip run reports are checked where they are
parsed.
"""
import collections
import subprocess
import types

import pytest
import torch

from chip_smoke import PRECISION_TILES
from glimpse_tpu_torch.kernels import bench_highpass, sass

# One kernel of each family, as nvcc mangles them in csrc/highpass.cu.
MANGLED = {
    "_ZN12_GLOBAL__N_116separable_kernelILi5ELi5ELi8EfEEvPKT2_PS2_iiiii": ("separable_kernel<5,5,8,float32>", 16),
    "_ZN12_GLOBAL__N_116separable_kernelILi5ELi5ELi8E13__nv_bfloat16EEvPKT2_PS2_iiiii":
        ("separable_kernel<5,5,8,bfloat16>", 32),
    "_ZN12_GLOBAL__N_116separable_kernelILi7ELi7ELi4E6__halfEEvPKT2_PS2_iiiii": ("separable_kernel<7,7,4,float16>", 16),
    "_ZN12_GLOBAL__N_116separable_kernelILi5ELi5ELi4EdEEvPKT2_PS2_iiiii": ("separable_kernel<5,5,4,float64>", 8),
    "_ZN12_GLOBAL__N_123separable_global_kernelILi5ELi5ELi8E6__halfEEvPKT2_PS2_iii":
        ("separable_global_kernel<5,5,8,float16>", 16),
    "_ZN12_GLOBAL__N_114generic_kernelILi25EfEEvPKT0_PS1_iiii": ("generic_kernel<25,float32>", 1),
}


@pytest.mark.parametrize("mangled", MANGLED)
def test_outputs_a_pass_by_kernel(mangled) -> None:
    """A staged 16-bit strip holds two tiles' outputs, so its pass computes
    4 R pixels; every other separable pass 2 R, a generic pass one."""
    assert sass._describe(mangled) == MANGLED[mangled]


def test_count_binary_reports_each_min_max(monkeypatch, tmp_path) -> None:
    """HMNMX2 and DMNMX are counted beside FMNMX, predicates and modifiers
    stripped, per pass and per output pixel, with ptxas's registers and
    spills."""
    packed, double = list(MANGLED)[1], list(MANGLED)[3]
    listing = (
        f"\n\tFunction : {packed}\n"
        "        /*0000*/                   HMNMX2.BF16_V2 R4, R2, R3, PT ;  /* 0x0 */\n"
        "        /*0010*/              @!P0 HMNMX2.BF16_V2 R5, R2, R3, !PT ;  /* 0x0 */\n"
        "        /*0020*/                   PRMT R6, R7, 0x5410, R8 ;  /* 0x0 */\n"
        "        /*0030*/                   EXIT ;  /* 0x0 */\n"
        f"\n\tFunction : {double}\n"
        "        /*0000*/                   DMNMX R4, R2, R6, PT ;  /* 0x0 */\n"
        "        /*0010*/                   DSETP.NAN.AND P0, PT, R2, R2, PT ;  /* 0x0 */\n"
        "        /*0020*/                   EXIT ;  /* 0x0 */\n"
    )
    monkeypatch.setattr(sass, "_tool", lambda name: name)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=listing))
    report = (
        f"ptxas info    : Compiling entry function '{packed}' for 'sm_90a'\n"
        "ptxas info    : Used 128 registers, 0 bytes spill stores\n"
        f"ptxas info    : Compiling entry function '{double}' for 'sm_90a'\n"
        "ptxas info    : Used 200 registers, 8 bytes spill stores\n"
    )
    rows = {row[0]: row for row in sass.count_binary(tmp_path / "lib.so", report)}
    kernel, per_pass, total, minmax, regs, spill, opcodes = rows["separable_kernel<5,5,8,bfloat16>"]
    assert (per_pass, total, minmax, regs, spill) == (32, 4, {"FMNMX": 0, "HMNMX2": 2, "DMNMX": 0}, 128, 0)
    assert opcodes == collections.Counter({"HMNMX2": 2, "PRMT": 1, "EXIT": 1})
    assert rows["separable_kernel<5,5,4,float64>"][3:6] == ({"FMNMX": 0, "HMNMX2": 0, "DMNMX": 1}, 200, 8)
    line = sass.describe(rows["separable_kernel<5,5,8,bfloat16>"], opcodes=2)
    assert "2 HMNMX2" in line and "0.1 HMNMX2" in line and "128 registers, 0 bytes spilled" in line


def test_bench_covers_the_main_paths_in_every_dtype() -> None:
    """--routes times every stack a main path launches in each 16- and
    64-bit dtype, and the issue rates measured include each design's
    min/max."""
    cases = {(shape, size, dtype) for shape, size, dtype in bench_highpass.ROUTE_CASES}
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        for shape in PRECISION_TILES:
            assert (shape, (5, 5), dtype) in cases
    assert set(PRECISION_TILES) <= set(bench_highpass.SHAPES)
    kinds = dict(bench_highpass._PIPE_KINDS)
    for kind in ("min.NaN.f32", "min.NaN.bf16x2", "min.NaN.f16x2", "min.f64"):
        assert kinds[kind] == 1
    assert kinds["float64 compare-and-select min/max"] == 2
