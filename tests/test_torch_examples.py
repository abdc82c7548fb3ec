"""The port's examples and its independence from JAX, on the CPU.

``examples/torch_*.py`` import only ``glimpse_tpu_torch``; each runs here
with ``--device cpu`` and must finish with its own checks passed (the
stabilization recovers every frame within 0.05 deg, the oblique run's fused
position error stays under 0.5 m). The package's modules import with
``jax`` and ``glimpse_tpu`` blocked.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCK = "import sys\nfor name in ('jax', 'jaxlib', 'glimpse_tpu'):\n    sys.modules[name] = None\n"


def run(code_or_path, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    command = [sys.executable, *(["-c", code_or_path] if "\n" in code_or_path else [str(code_or_path)]), *args]
    return subprocess.run(command, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name, expect", [
    ("torch_stabilize_sequence.py", "all frames recovered within 0.05 deg"),
    ("torch_oblique_3d_tracking.py", "fused: median final position error"),
    ("torch_end_to_end.py", "tracking: median velocity error"),
])
def test_example_runs_on_the_cpu(name, expect) -> None:
    code = BLOCK + f"sys.argv = ['{name}', '--device', 'cpu']\nimport runpy\nrunpy.run_path('examples/{name}', run_name='__main__')\n"
    proc = run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout


def test_port_imports_without_jax() -> None:
    code = BLOCK + (
        "import glimpse_tpu_torch, glimpse_tpu_torch.optimize, glimpse_tpu_torch.convert\n"
        "import glimpse_tpu_torch.profiling, glimpse_tpu_torch.parallel\n"
        "assert not any(m.split('.')[0] in ('jax', 'glimpse_tpu') and sys.modules[m] is not None for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
