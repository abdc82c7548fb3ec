"""Count the SASS instructions of the high-pass kernels, per output pixel.

Run on a machine with the CUDA toolkit, from the root of a checkout:
``python -m glimpse_tpu_torch.kernels.sass [source.cu ...]``. Each source is
compiled to a cubin for ``sm_90a`` with the flags the library is built with
(with no argument: the high-pass library itself, built as on first use) and
disassembled with ``cuobjdump -sass``. For every kernel in it the script
prints one line: its static instruction count, its min/max instructions
(``FMNMX`` on float, ``HMNMX2`` on two packed 16-bit values, ``DMNMX`` on
double), ptxas's registers and spills, the counts divided by the output
pixels one pass of its loop computes (2 R for ``separable_kernel<KH, KW,
R, type>`` and ``separable_global_kernel``, 4 R for the staged 16-bit
``separable_kernel``, whose packed lanes hold two tiles, 1 for a kernel
that computes one pixel a pass), and its twelve most frequent opcodes.
sm_90a has no ``DMNMX``: the float64 kernels compare and select (``DSETP``,
``FSEL``), so their ``DMNMX`` count shows that ``min.f64`` did not lower to
one instruction. Static counts of straight-line network code are what one
pass executes; the staging loops are counted once.
"""
import collections
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from . import _build

# Per-pass outputs from a kernel's mangled name: separable_kernel<KH, KW, R>
# and separable_global_kernel<KH, KW, R> compute an R x 2 strip, of two tiles
# in the staged 16-bit kernel; every other kernel one pixel. A template on the
# element type (since the 16- and 64-bit kernels) carries it after the sizes.
_SEPARABLE = re.compile(r"(separable(?:_global)?_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E(f|d|6__half|13__nv_bfloat16)?")
_TEMPLATE = re.compile(r"(generic(?:_global)?_kernel|median_highpass_kernel)ILi(\d+)E(f|d|6__half|13__nv_bfloat16)?")
_TYPES = {"f": "float32", "d": "float64", "6__half": "float16", "13__nv_bfloat16": "bfloat16"}
# The min/max opcodes each row counts.
MINMAX = ("FMNMX", "HMNMX2", "DMNMX")


def _typed(sizes: str, code) -> str:
    return f"{sizes},{_TYPES[code]}" if code else sizes


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found: this script needs the CUDA toolkit")
    return found


def _describe(mangled: str):
    m = _SEPARABLE.search(mangled)
    if m:
        kh, kw, r = map(int, m.groups()[1:4])
        packed = m.group(1) == "separable_kernel" and m.group(5) in ("6__half", "13__nv_bfloat16")
        return f"{m.group(1)}<{_typed(f'{kh},{kw},{r}', m.group(5))}>", (4 if packed else 2) * r
    m = _TEMPLATE.search(mangled)
    if m:
        return f"{m.group(1)}<{_typed(m.group(2), m.group(3))}>", 1
    return mangled, 1


def count_binary(binary: Path, ptxas_report: str) -> list:
    """[(kernel, outputs per pass, instructions, {opcode: count} of MINMAX,
    registers, spill bytes, opcode counts)] for each kernel in a cubin or a
    shared library, with registers and spills read from ptxas's ``-v``
    report of its build."""
    registers = {}
    for block in re.split(r"ptxas info\s*: Compiling entry function ", ptxas_report)[1:]:
        name = re.match(r"'(\w+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores", block)
        registers[name] = (int(regs.group(1)) if regs else None, int(spills.group(1)) if spills else 0)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(binary)], capture_output=True, text=True, check=True).stdout
    rows = []
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = chunk.split("\n", 1)[0].strip()
        instructions = [b for b in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk) if b.strip()]
        opcodes = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0].split(".")[0]
                                      for b in instructions)
        kernel, per_pass = _describe(mangled)
        regs, spill = registers.get(mangled, (None, 0))
        rows.append((kernel, per_pass, len(instructions), {op: opcodes[op] for op in MINMAX}, regs, spill, opcodes))
    return rows


def count(source: Path) -> list:
    """:func:`count_binary` of ``source`` compiled to a cubin for sm_90a."""
    out_dir = _build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:8]
    cubin = out_dir / f"{source.stem}-{digest}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_tool("nvcc"), *flags, "-cubin", "-o", str(cubin), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return count_binary(cubin, proc.stdout + proc.stderr)


def count_built(name: str) -> list:
    """:func:`count_binary` of the library ``_build.load(name)`` built."""
    _build.load(name)
    lib = _build.library_path(name)
    return count_binary(lib, lib.with_suffix(".log").read_text())


def describe(row, opcodes: int = 0) -> str:
    """One line for a row of :func:`count_binary`; with ``opcodes``, the
    most frequent that many opcodes too."""
    kernel, per_pass, total, minmax, regs, spill, counts = row
    line = (
        f"{kernel}: {total} instructions, {', '.join(f'{n} {op}' for op, n in minmax.items())}, {regs} registers,"
        f" {spill} bytes spilled; per output pixel {total / per_pass:.1f} instructions, "
        + ", ".join(f"{n / per_pass:.1f} {op}" for op, n in minmax.items())
    )
    if opcodes:
        line += "; " + ", ".join(f"{op} {n}" for op, n in counts.most_common(opcodes))
    return line


def main(argv) -> None:
    if not argv:
        for row in count_built("highpass"):
            print(f"{_build.library_path('highpass').name}: {describe(row, 12)}", flush=True)
    for source in map(Path, argv):
        for row in count(source):
            print(f"{source}: {describe(row, 12)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
