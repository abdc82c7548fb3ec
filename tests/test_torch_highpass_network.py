"""The high-pass kernel's selection networks, compiled for the host.

``glimpse_tpu_torch/csrc/highpass.cu`` writes its networks as
``__host__ __device__`` templates on the value type above its kernels, with
a host version of each type's min and max. The float32 kernels run them on
float; the staged 16-bit kernel on two tiles' bfloat16 or float16 values
packed in one register (NaN-propagating lane by lane); the staged float64
kernel on doubles ordered by min.f64 / max.f64, which drop NaN, with NaN
carried in a flag beside the network; the other float64 kernels on doubles
by compare and select. This test compiles that part of the file with the
host's C++ compiler into a small program that runs each network on random
windows and holds every output to a sort-based median: exactly equal, NaN
wherever the window holds a NaN. It checks the networks the card runs,
without a card; skips where there is no C++ compiler.
"""
import shutil
import subprocess
from pathlib import Path

import pytest

SOURCE = Path(__file__).resolve().parents[1] / "glimpse_tpu_torch" / "csrc" / "highpass.cu"
SEPARABLE = [(3, 3, 8), (5, 5, 8), (7, 7, 4), (3, 7, 8), (9, 5, 4), (5, 5, 16), (5, 5, 4)]
# The global float64 kernels' windows, at half the float32 strip height.
SEPARABLE_DOUBLE = [(3, 3, 4), (5, 5, 4), (7, 7, 2), (3, 7, 4), (9, 5, 2)]
# The staged float64 kernel's windows at its strip heights (R64 of
# GLIMPSE_SEPARABLE_WINDOWS), and three more.
SEPARABLE_FLAGGED = [(3, 3, 4), (5, 5, 4), (7, 7, 2), (3, 7, 4), (9, 5, 2), (5, 5, 2), (5, 5, 8), (7, 7, 1)]
# The staged 16-bit kernel's windows, at the float32 strip heights.
SEPARABLE_PACKED = [(3, 3, 8), (5, 5, 8), (7, 7, 4), (3, 7, 8), (9, 5, 4)]
PACKED = {"bfloat16": "b", "float16": "h"}
GENERIC = [(9, 1), (9, 5), (9, 9), (25, 11), (25, 21), (25, 25), (49, 27), (49, 35), (49, 49)]
KINDS = {"normal": 0, "binary": 1, "ties": 2, "nan-inf": 3}

HARNESS = r"""
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
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

// A float drawn by draw_float as a 16-bit lane: bfloat16 by truncation,
// float16 by truncation with overflow to inf and underflow to 0 (every
// value drawn is then exact in both).
static unsigned lane_bits(Bf16x2, float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof(u));
  return f != f ? 0x7fc0 : u >> 16;
}

static unsigned lane_bits(F16x2, float f) {
  if (f != f) return 0x7e00;
  const unsigned sign = f < 0 ? 0x8000 : 0;
  const float a = std::fabs(f);
  if (a >= 65536.0f) return sign | 0x7c00;
  if (a < 6.103515625e-05f) return sign;
  int e;
  const float m = std::frexp(a, &e);  // a = m 2^e, m in [0.5, 1)
  if (e + 14 > 30) return sign | 0x7c00;
  return sign | static_cast<unsigned>(e + 14) << 10 | (static_cast<unsigned>(m * 2048.0f) & 1023);
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

// Each lane of each tap drawn on its own; in the nan-inf draw a lane never
// holds NaN where the other does, so a NaN of one tile must stay in its lane.
template <int KH, int KW, int R, typename P>
static int packed(int kind, int trials) {
  std::mt19937 rng(KH * 1000 + KW * 10 + R + kind + 7);
  for (int t = 0; t < trials; ++t) {
    P x[R + KH - 1][KW + 1];
    for (auto& row : x) {
      for (P& v : row) {
        const float a = draw_float(kind, rng);
        float b = draw_float(kind, rng);
        while (a != a && b != b) b = draw_float(kind, rng);
        v.bits = lane_bits(v, a) | lane_bits(v, b) << 16;
      }
    }
    P med[2][R];
    strip_medians<KH, KW, R>(x, med);
    for (int k = 0; k < 2; ++k) {
      for (int c = 0; c < 2; ++c) {
        for (int r = 0; r < R; ++r) {
          std::vector<float> window;
          for (int i = 0; i < KH; ++i) {
            for (int j = 0; j < KW; ++j) window.push_back(lane_float(x[r + i][c + j], x[r + i][c + j].bits >> (16 * k) & 0xffff));
          }
          const float got = lane_float(med[c][r], med[c][r].bits >> (16 * k) & 0xffff);
          if (!same(got, median_of(window))) {
            std::printf("packed<%d,%d,%d> trial %d lane %d output (%d, %d): %g, want %g\n", KH, KW, R, t, k, r, c,
                        static_cast<double>(got), static_cast<double>(median_of(window)));
            return 1;
          }
        }
      }
    }
  }
  return 0;
}

template <int KH, int KW, int R>
static int flagged(int kind, int trials) {
  std::mt19937 rng(KH * 1000 + KW * 10 + R + kind + 11);
  for (int t = 0; t < trials; ++t) {
    double x[R + KH - 1][KW + 1];
    for (auto& row : x) for (double& v : row) v = draw<double>(kind, rng);
    double med[2][R];
    strip_medians_flagged<KH, KW, R>(x, med);
    for (int c = 0; c < 2; ++c) {
      for (int r = 0; r < R; ++r) {
        std::vector<double> window;
        for (int i = 0; i < KH; ++i) for (int j = 0; j < KW; ++j) window.push_back(x[r + i][c + j]);
        if (!same(med[c][r], median_of(window))) {
          std::printf("flagged<%d,%d,%d> trial %d output (%d, %d): %.17g, want %.17g\n", KH, KW, R, t, r, c, med[c][r],
                      median_of(window));
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
  } else if (argv[1][0] == 'p') {
#define PACKED(KH, KW, R)                                                                       \
  if (a == KH && b == KW && c == R)                                                             \
    return argv[7][0] == 'b' ? packed<KH, KW, R, Bf16x2>(kind, trials) : packed<KH, KW, R, F16x2>(kind, trials);
    PACKED(3, 3, 8) PACKED(5, 5, 8) PACKED(7, 7, 4) PACKED(3, 7, 8) PACKED(9, 5, 4)
  } else if (argv[1][0] == 'f') {
#define FLAGGED(KH, KW, R) \
  if (a == KH && b == KW && c == R) return flagged<KH, KW, R>(kind, trials);
    FLAGGED(3, 3, 4) FLAGGED(5, 5, 4) FLAGGED(7, 7, 2) FLAGGED(3, 7, 4) FLAGGED(9, 5, 2) FLAGGED(5, 5, 2)
    FLAGGED(5, 5, 8) FLAGGED(7, 7, 1)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kh, kw, rows", SEPARABLE_PACKED)
@pytest.mark.parametrize("dtype", PACKED)
def test_packed_network_is_the_median(harness, dtype, kh, kw, rows, kind) -> None:
    """The staged 16-bit kernel's network on two tiles' values packed in one
    register, each lane drawn on its own (NaN never in both lanes of a
    tap): every output of each lane equals the median of that lane's
    window, so neither lane reaches the other."""
    _run(harness, "p", kh, kw, rows, KINDS[kind], 2000, PACKED[dtype])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kh, kw, rows", SEPARABLE_FLAGGED)
def test_flagged_float64_network_is_the_median(harness, kh, kw, rows, kind) -> None:
    """The staged float64 kernel's network: min.f64 / max.f64, which drop
    NaN, with a flag a window that sets NaN; on values float32 cannot hold,
    every output equals the sort-based median, NaN exactly where the window
    holds one."""
    _run(harness, "f", kh, kw, rows, KINDS[kind], 2000)
