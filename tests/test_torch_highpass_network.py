"""The high-pass kernel's selection networks, compiled for the host.

``glimpse_tpu_torch/csrc/highpass.cu`` writes its networks as
``__host__ __device__`` templates on the value type above its kernels, with
a host version of the NaN-propagating min and max. The float32 and 16-bit
kernels run them on float, the float64 kernels on double. This test compiles that part of the file
with the host's C++ compiler into a small program that runs each network on
random windows and holds every output to a sort-based median: exactly equal,
NaN wherever the window holds a NaN. It checks the networks the card runs,
without a card; skips where there is no C++ compiler.
"""
import shutil
import subprocess
from pathlib import Path

import pytest

SOURCE = Path(__file__).resolve().parents[1] / "glimpse_tpu_torch" / "csrc" / "highpass.cu"
SEPARABLE = [(3, 3, 8), (5, 5, 8), (7, 7, 4), (3, 7, 8), (9, 5, 4), (5, 5, 16), (5, 5, 4)]
# The float64 kernels' windows, at half the float32 strip height.
SEPARABLE_DOUBLE = [(3, 3, 4), (5, 5, 4), (7, 7, 2), (3, 7, 4), (9, 5, 2)]
GENERIC = [(9, 1), (9, 5), (9, 9), (25, 11), (25, 21), (25, 25), (49, 27), (49, 35), (49, 49)]
KINDS = {"normal": 0, "binary": 1, "ties": 2, "nan-inf": 3}

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "networks.h"
}  // namespace

static float draw_float(int kind, std::mt19937& rng);

template <typename V>
static V draw(int kind, std::mt19937& rng) {
  return static_cast<V>(draw_float(kind, rng));
}

template <>
double draw<double>(int kind, std::mt19937& rng) {
  // Values float32 cannot hold, so a network that narrowed would be caught.
  const double v = static_cast<double>(draw_float(kind, rng));
  return v != v || v == INFINITY || v == -INFINITY ? v : v * (1.0 + 1e-12 * v);
}

static float draw_float(int kind, std::mt19937& rng) {
  std::normal_distribution<float> normal;
  std::uniform_int_distribution<int> table(0, 63), pick(0, 999);
  if (kind == 0) return normal(rng);
  if (kind == 1) return static_cast<float>(table(rng) & 1);
  const float v = static_cast<float>(table(rng)) / 8.0f;
  if (kind == 2) return v;
  const int p = pick(rng);
  return p < 8 ? NAN : (p < 40 ? INFINITY : (p < 72 ? -INFINITY : v));
}

template <typename V>
static V median_of(std::vector<V> v) {
  for (V x : v) if (x != x) return NAN;
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

template <typename V>
static bool same(V got, V want) { return want != want ? got != got : got == want; }

template <int KH, int KW, int R, typename V>
static int separable(int kind, int trials) {
  std::mt19937 rng(KH * 1000 + KW * 10 + R + kind);
  for (int t = 0; t < trials; ++t) {
    V x[R + KH - 1][KW + 1];
    for (auto& row : x) for (V& v : row) v = draw<V>(kind, rng);
    V med[2][R];
    strip_medians<KH, KW, R>(x, med);
    for (int c = 0; c < 2; ++c) {
      for (int r = 0; r < R; ++r) {
        std::vector<V> window;
        for (int i = 0; i < KH; ++i) for (int j = 0; j < KW; ++j) window.push_back(x[r + i][c + j]);
        if (!same(med[c][r], median_of(window))) {
          std::printf("separable<%d,%d,%d> trial %d output (%d, %d): %g, want %g\n", KH, KW, R, t, r, c,
                      static_cast<double>(med[c][r]), static_cast<double>(median_of(window)));
          return 1;
        }
      }
    }
  }
  return 0;
}

template <int S, typename V>
static int generic(int taps, int kind, int trials) {
  std::mt19937 rng(S * 100 + taps + kind);
  for (int t = 0; t < trials; ++t) {
    Vec<S, V> v;
    std::vector<V> window;
    for (int i = 0; i < S; ++i) {
      v[i] = i < taps ? draw<V>(kind, rng) : ((i - taps) % 2 ? V(INFINITY) : V(-INFINITY));
      if (i < taps) window.push_back(v[i]);
    }
    if (!same(sort(v)[S / 2], median_of(window))) {
      std::printf("generic<%d> taps %d trial %d: %g, want %g\n", S, taps, t, static_cast<double>(sort(v)[S / 2]),
                  static_cast<double>(median_of(window)));
      return 1;
    }
  }
  return 0;
}

int main(int argc, char** argv) {
  const int a = std::atoi(argv[2]), b = std::atoi(argv[3]), c = std::atoi(argv[4]);
  const int kind = std::atoi(argv[5]), trials = std::atoi(argv[6]);
  const bool wide = argc > 7 && argv[7][0] == 'd';  // double, as the float64 kernels run
  if (argv[1][0] == 's') {
#define CASE(KH, KW, R)                                                   \
  if (a == KH && b == KW && c == R)                                       \
    return wide ? separable<KH, KW, R, double>(kind, trials) : separable<KH, KW, R, float>(kind, trials);
    CASE(3, 3, 8) CASE(5, 5, 8) CASE(7, 7, 4) CASE(3, 7, 8) CASE(9, 5, 4) CASE(5, 5, 16) CASE(5, 5, 4)
    CASE(3, 3, 4) CASE(7, 7, 2) CASE(3, 7, 4) CASE(9, 5, 2)
  } else {
    if (a == 9) return wide ? generic<9, double>(b, kind, trials) : generic<9, float>(b, kind, trials);
    if (a == 25) return wide ? generic<25, double>(b, kind, trials) : generic<25, float>(b, kind, trials);
    if (a == 49) return wide ? generic<49, double>(b, kind, trials) : generic<49, float>(b, kind, trials);
  }
  std::printf("no such network\n");
  return 2;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory) -> Path:
    compiler = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler")
    source = SOURCE.read_text()
    networks = source[: source.index("// ---- Kernels")].replace("#include <cuda_runtime.h>", "")
    root = tmp_path_factory.mktemp("highpass_networks")
    (root / "networks.h").write_text(networks)
    (root / "harness.cpp").write_text(HARNESS)
    program = root / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++17", "-O1", "-o", str(program), str(root / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return program


def _run(harness: Path, *args) -> None:
    proc = subprocess.run([str(harness), *map(str, args)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kh, kw, rows", SEPARABLE)
def test_separable_network_is_the_median(harness, kh, kw, rows, kind) -> None:
    """Every output of an R x 2 strip equals the median of its window, for
    the compiled windows and strip heights and two more heights."""
    _run(harness, "s", kh, kw, rows, KINDS[kind], 3000)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padded, taps", GENERIC)
def test_generic_network_is_the_median(harness, padded, taps, kind) -> None:
    """The generic kernel's pruned merge sort of ``taps`` values padded to
    9, 25 or 49 with alternating -inf and +inf is their median."""
    _run(harness, "g", padded, taps, 0, KINDS[kind], 3000)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("network", [("s", kh, kw, rows) for kh, kw, rows in SEPARABLE_DOUBLE]
                         + [("g", padded, taps, 0) for padded, taps in GENERIC[::2]])
def test_float64_network_is_the_median(harness, network, kind) -> None:
    """The networks on double, as the float64 kernels run them (their
    compare-and-select min and max, half the strip height), on values
    float32 cannot hold: every output equals the sort-based median."""
    _run(harness, *network, KINDS[kind], 2000, "d")
