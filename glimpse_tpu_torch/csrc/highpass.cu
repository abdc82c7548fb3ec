// Median high-pass over a stack of tiles: out = tile - median_{kh x kw}(tile).
//
// Replaces the TPU kernel glimpse_tpu/kernels/highpass_pallas.py
// (median_highpass, body _median_hp_kernel). Same function, same domain:
// tiles (N, h, w) of float32, float64, float16 or bfloat16, the output in the
// input's type, odd kh and kw with kh * kw <= 49, symmetric padding that
// includes the edge pixel (row -1 reads row 0, row h reads row h - 1), as
// numpy's mode="symmetric". The TPU kernel also asks h >= kh / 2 + 1 and
// w >= kw / 2 + 1; this one takes any tile of at least one pixel (7.).
//
// What bounds it on the card: the issue of min/max, not bytes. Each tile is
// read once and written once (8 bytes a pixel in float32: 157 MB, 47 us at 3.35 TB/s
// for the (20,480, 31, 31) stack of the main path), but a median network
// costs tens of min/max a pixel, and Hopper issues min.NaN.f32 (FMNMX) at 62
// a clock per SM, half its FP32 add rate (bench_highpass.py measures both).
// So the design spends its effort on the network and hides the loads behind
// it:
//
// 1. A selection network shared between neighbours (A. Adams, "Fast median
//    filters using separable sorting networks", ACM TOG 40(4), 2021). Each
//    thread owns a strip of R rows x 2 columns of outputs. It sorts each row
//    segment of its window once (the kw - 1 taps the two columns share are
//    sorted once, then each column's extra tap is merged in), then merges the
//    sorted segments down the strip in a binary tree whose inner nodes, the
//    segments that several outputs share, are merged once. Every merged node
//    keeps only the ranks that can still be the median of some window that
//    holds it; the ranks it drops below the median shift the target rank.
//    Each leaf selects its median from two sorted lists as min_i max(a_i,
//    b_{t-i}). All sizes and ranks are template constants, so the network is
//    straight-line register code and the compiler drops every half of a
//    compare-exchange whose output is not kept. For 5x5 the compiled kernel
//    does 63.8 FMNMX per output pixel (1,020 for a strip of 16; sass.py
//    counts them), against 444 for an odd-even transposition sort of the 25
//    taps (600 before the compiler prunes it). With the loads, the index
//    work and the stores it issues 110 instructions a pixel; the min/max
//    alone, at 62 a clock per SM, take three quarters of its time on the
//    (20,480, 31, 31) stack, so their issue, not memory, sets it.
// 2. Compile-time windows. separable_kernel<KH, KW, R> is instantiated for
//    3x3, 5x5, 7x7, 3x7 and 9x5. Every other odd window (kh * kw <= 49) runs
//    generic_kernel<S>, one output pixel a thread: its taps are padded to
//    S = 9, 25 or 49 with equal numbers of -inf and +inf, which leaves the
//    median where it was, read through a table of offsets built once a
//    block, and reduced by Batcher's merge sort, of which the compiler keeps
//    only what reaches the middle wire (202 min/max for S = 25).
//    glimpse_median_highpass_typed picks the kernel;
//    glimpse_median_highpass_variant_typed names the one it picks.
// 3. NaN that propagates. Every min and max is PTX min.NaN.f32 / max.NaN.f32:
//    if either input is NaN the result is NaN. In a selection network every
//    input of a window reaches its median through some chain of min and max,
//    so a window that holds a NaN yields NaN, as torch.median does; no input
//    outside the window reaches it. Selection does no arithmetic, so every
//    other result, ties and +-inf included, is bit-equal to the plain version.
// 4. Staging. A block takes G tiles at once (G * per-tile threads ~ 128, so a
//    pass over the tiles is not ragged) and loops over groups of G tiles, a
//    persistent grid of as many blocks as fit on the card. The next group is
//    copied into the other of two shared-memory buffers with cp.async (16
//    bytes a copy where source and buffer line up) while the current group
//    runs its network. A group of tiles is one contiguous range of the input,
//    so the copies are coalesced. The symmetric padding is read, not stored:
//    each thread reflects its strip's row and column indices once. TMA does
//    not fit: a 31-float row (124 bytes) is not the multiple of 16 bytes a
//    tensor map's stride needs.
// 5. Element types. Every kernel is a template on the tile's type T, and
//    the staged separable kernel has a design for each width:
//    - 16 bits (packed_strip): a work item takes two tiles of its block's
//      group at once, and each tap packs their pixels at one (y, x) into one
//      32-bit register, lane 0 and lane 1. The network runs on the packed
//      value with min.NaN.bf16x2 / min.NaN.f16x2 (HMNMX2, which Hopper issues
//      at 119 a clock per SM, twice FMNMX's rate), so one instruction selects
//      in both tiles: both share every index and branch, selection in 16
//      bits is exact, and NaN stays in its lane. Each lane's difference is
//      taken in float and rounded once, as the plain version's
//      (x.float() - median.float()).to(T). A group of odd size leaves one
//      tile without a partner: its lane b repeats lane a and is not stored.
//      For 5x5 it does 28.4 HMNMX2 and 70.8 instructions a pixel at 128-134
//      registers (float32's network: 63.8 FMNMX, 110.5 instructions); the
//      packing, two 16-bit shared loads and a PRMT a tap, and the index work
//      are most of the rest, and latency, not issue, bounds it.
//    - float64 (strip_medians_flagged): Hopper has no 64-bit min/max
//      instruction (min.f64 is a DSETP-and-FSEL sequence at 13.6 a clock per
//      SM), and a NaN-propagating compare and select costs about three DSETP
//      and eight FSEL a compare-exchange, bound by DSETP at about 16 a clock
//      per SM. The network runs without NaN tests (one DSETP and four FSEL a
//      compare-exchange, F64 above; 28.2 min/max a clock) and NaN goes
//      beside it: a flag a tap, OR-ed over each window separably, sets the
//      outputs whose window holds a NaN. Strip heights R64 keep every
//      instance from spilling (5x5: R = 4, 210 registers).
//    The global and generic routes and the thin tiles' fold widen 16-bit
//    taps to float and run the float32 network, and run float64 on double by
//    the NaN-propagating compare and select with half the float32 strip
//    height. The staging counts in elements of T, so 16-byte lines hold 8, 4
//    or 2 of them; the elements before the first line and after the last go
//    by cp.async too, a 2-byte one in the 4-byte word that holds it.
// 6. Tiles of any size. A tile that one block's shared memory cannot hold
//    (in float32 about 170 x 170 pixels for a separable window, 240 x 240
//    for the others) takes the global route: separable_global_kernel and
//    generic_global_kernel run the same networks, the same reflect() at the
//    tile's own edges and the same widening and rounding, but read each
//    window straight from device memory through the read-only cache, and
//    their grid covers every strip (or pixel) of every tile, so one large
//    tile spreads over many SMs. The launcher picks the route on the host
//    from (n, h, w, kh, kw, element size) (takes_global): a few tiles that
//    would each keep one staged block looping take the global route too;
//    the main path's stacks keep the staged route above, unchanged, which
//    is 8-11 % faster there. Such tiles come one or a few a call (the host
//    Tracker's, a wide search box's), so the call, not bytes or min/max
//    issue, bounds them: 0.02-0.05 ms up to 1,024 x 1,024 on an H100
//    (chip_smoke phase 3), where the byte bound is 0.0025 ms.
// 7. Tiles thinner than half the window (h < kh / 2 + 1 or w < kw / 2 + 1,
//    a 3 x 3 template under 7 x 7 taps): their padding reflects more than
//    once, as numpy's symmetric mode pads an axis by more than its length,
//    so an index folds with period 2n (reflect_periodic). Only
//    generic_global_kernel<S, T, true> runs that fold, and the launcher
//    sends every thin tile there (thin()); every other launch keeps the
//    one-fold reflect() and compiles to the code it had before.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

// ---- Selection networks (host and device, so they can be tested anywhere) --
//
// The networks are templates on the value type V, whose vmin and vmax they
// call. Each V has its own:
// - float: min.NaN.f32 / max.NaN.f32, NaN if either input is NaN;
// - double: compare and select, NaN if either input is NaN (the generic,
//   global and thin routes' float64 kernels);
// - F64: a double ordered by one comparison a compare-exchange and no NaN
//   test (the staged float64 kernel, which carries NaN in a flag beside the
//   network: strip_medians_flagged);
// - Bf16x2, F16x2: two bfloat16 or float16 values, one of each of two
//   tiles, in one 32-bit register, ordered lane by lane by
//   min.NaN.bf16x2 / min.NaN.f16x2 (the staged 16-bit kernel).
// On the host each is the same order written out, so a host compiler runs
// the code the card runs.

__host__ __device__ __forceinline__ float vmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? NAN : (b < a ? b : a);
#endif
}

__host__ __device__ __forceinline__ float vmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? NAN : (a < b ? b : a);
#endif
}

// PTX has no min.NaN.f64: compare and select, on the card as on the host.
__host__ __device__ __forceinline__ double vmin(double a, double b) {
  return (a != a || b != b) ? static_cast<double>(NAN) : (b < a ? b : a);
}

__host__ __device__ __forceinline__ double vmax(double a, double b) {
  return (a != a || b != b) ? static_cast<double>(NAN) : (a < b ? b : a);
}

// vmin and vmax of one pair test the same b < a, so a compare-exchange is
// one DSETP and four FSEL. Hopper has no 64-bit min/max instruction:
// min.f64 lowers to a longer compare-and-select that also tests for NaN.
// Where an input is NaN the comparison is false and the pair passes
// unchanged; strip_medians_flagged overrides every window that holds it.
struct F64 {
  double v;
};

__host__ __device__ __forceinline__ F64 vmin(F64 a, F64 b) { return {b.v < a.v ? b.v : a.v}; }

__host__ __device__ __forceinline__ F64 vmax(F64 a, F64 b) { return {b.v < a.v ? a.v : b.v}; }

// Lane 0 in the low 16 bits, lane 1 in the high 16.
struct Bf16x2 {
  unsigned bits;
};
struct F16x2 {
  unsigned bits;
};

#ifndef __CUDA_ARCH__
// One lane's 16 bits as a float, on the host.
inline float lane_float(Bf16x2, unsigned h) {
  const unsigned u = h << 16;
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
}

inline float lane_float(F16x2, unsigned h) {
  const unsigned e = (h >> 10) & 31, m = h & 1023;
  const float magnitude = e == 0 ? ldexpf(static_cast<float>(m), -24)
                                 : (e == 31 ? (m ? NAN : INFINITY) : ldexpf(static_cast<float>(m | 1024), static_cast<int>(e) - 25));
  return h & 0x8000 ? -magnitude : magnitude;
}

// Lane by lane: the canonical NaN (0x7fff) if either lane is NaN, else the
// smaller (kMin) or the larger one, as min.NaN / max.NaN on the card.
template <bool kMin, typename P>
P lanewise(P a, P b) {
  P r{0};
  for (int k = 0; k < 2; ++k) {
    const unsigned x = (a.bits >> (16 * k)) & 0xffff, y = (b.bits >> (16 * k)) & 0xffff;
    const float fx = lane_float(a, x), fy = lane_float(b, y);
    const unsigned pick = (fx != fx || fy != fy) ? 0x7fff : ((kMin ? fy < fx : fx < fy) ? y : x);
    r.bits |= pick << (16 * k);
  }
  return r;
}
#endif

__host__ __device__ __forceinline__ Bf16x2 vmin(Bf16x2 a, Bf16x2 b) {
#ifdef __CUDA_ARCH__
  Bf16x2 r;
  asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r.bits) : "r"(a.bits), "r"(b.bits));
  return r;
#else
  return lanewise<true>(a, b);
#endif
}

__host__ __device__ __forceinline__ Bf16x2 vmax(Bf16x2 a, Bf16x2 b) {
#ifdef __CUDA_ARCH__
  Bf16x2 r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r.bits) : "r"(a.bits), "r"(b.bits));
  return r;
#else
  return lanewise<false>(a, b);
#endif
}

__host__ __device__ __forceinline__ F16x2 vmin(F16x2 a, F16x2 b) {
#ifdef __CUDA_ARCH__
  F16x2 r;
  asm("min.NaN.f16x2 %0, %1, %2;" : "=r"(r.bits) : "r"(a.bits), "r"(b.bits));
  return r;
#else
  return lanewise<true>(a, b);
#endif
}

__host__ __device__ __forceinline__ F16x2 vmax(F16x2 a, F16x2 b) {
#ifdef __CUDA_ARCH__
  F16x2 r;
  asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(r.bits) : "r"(a.bits), "r"(b.bits));
  return r;
#else
  return lanewise<false>(a, b);
#endif
}

// A list of N values of type V held in registers (every index is a
// compile-time constant once the networks below are unrolled).
template <int N, typename V = float>
struct Vec {
  V v[N > 0 ? N : 1];
  __host__ __device__ __forceinline__ V& operator[](int i) { return v[i]; }
  __host__ __device__ __forceinline__ const V& operator[](int i) const { return v[i]; }
};

template <int K, int LO, int M, typename V>
__host__ __device__ __forceinline__ Vec<K, V> slice(const Vec<M, V>& a) {
  Vec<K, V> out;
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = a[LO + i];
  return out;
}

// Batcher's odd-even merge of sorted a (M) and sorted b (N), any sizes.
template <int M, int N, typename V>
__host__ __device__ __forceinline__ Vec<M + N, V> merge(const Vec<M, V>& a, const Vec<N, V>& b) {
  Vec<M + N, V> out;
  if constexpr (M == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = b[i];
  } else if constexpr (N == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) out[i] = a[i];
  } else if constexpr (M == 1 && N == 1) {
    out[0] = vmin(a[0], b[0]);
    out[1] = vmax(a[0], b[0]);
  } else {
    Vec<(M + 1) / 2, V> a_even;
    Vec<M / 2, V> a_odd;
    Vec<(N + 1) / 2, V> b_even;
    Vec<N / 2, V> b_odd;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i % 2 == 0) a_even[i / 2] = a[i]; else a_odd[i / 2] = a[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i % 2 == 0) b_even[i / 2] = b[i]; else b_odd[i / 2] = b[i];
    }
    const Vec<(M + 1) / 2 + (N + 1) / 2, V> v = merge(a_even, b_even);
    const Vec<M / 2 + N / 2, V> w = merge(a_odd, b_odd);
    constexpr int NV = (M + 1) / 2 + (N + 1) / 2;
    constexpr int NW = M / 2 + N / 2;
    constexpr int P = NW < NV - 1 ? NW : NV - 1;  // compare-exchange w[i] with v[i + 1]
    out[0] = v[0];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      out[1 + 2 * i] = vmin(w[i], v[i + 1]);
      out[2 + 2 * i] = vmax(w[i], v[i + 1]);
    }
#pragma unroll
    for (int i = P; i < NW; ++i) out[1 + P + i] = w[i];
#pragma unroll
    for (int i = P + 1; i < NV; ++i) out[P + i] = v[i];
  }
  return out;
}

// Batcher's merge sort.
template <int N, typename V>
__host__ __device__ __forceinline__ Vec<N, V> sort(const Vec<N, V>& a) {
  if constexpr (N <= 1) {
    return a;
  } else {
    constexpr int H = N / 2;
    return merge(sort(slice<H, 0>(a)), sort(slice<N - H, H>(a)));
  }
}

// Rank T (0-based) of the union of sorted a (M) and sorted b (N):
// min over i + j = T + 1 of max(a[i - 1], b[j - 1]), an absent side left out.
template <int M, int N, int T, typename V>
__host__ __device__ __forceinline__ V select(const Vec<M, V>& a, const Vec<N, V>& b) {
  V r{};
  bool first = true;
#pragma unroll
  for (int i = 0; i <= T + 1; ++i) {
    const int j = T + 1 - i;
    if (i > M || j > N) continue;
    const V term = i == 0 ? b[j - 1] : (j == 0 ? a[i - 1] : vmax(a[i - 1], b[j - 1]));
    r = first ? term : vmin(r, term);
    first = false;
  }
  return r;
}

constexpr int max_of(int a, int b) { return a > b ? a : b; }

// Merge blocks [E0, E1) of sorted lists of B values, in a balanced tree.
constexpr int floor_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

template <int B, int E0, int E1, int NB, typename V>
__host__ __device__ __forceinline__ Vec<(E1 - E0) * B, V> merge_range(const Vec<B, V> (&blocks)[NB]) {
  if constexpr (E1 - E0 <= 0) {
    return Vec<0, V>{};
  } else if constexpr (E1 - E0 == 1) {
    return blocks[E0];
  } else {
    constexpr int MID = E0 + floor_pow2(E1 - E0 - 1);
    return merge(merge_range<B, E0, MID>(blocks), merge_range<B, MID, E1>(blocks));
  }
}

// Which ranks of a sorted node of m values can still be the median: the
// windows that hold the node have n values left and want rank t of them.
// Dropping `lo` values from below makes the target t - lo.
struct Keep {
  int lo, count, t, n;
};

constexpr Keep keep(int m, int t, int n) {
  const int lo = t - (n - m) > 0 ? t - (n - m) : 0;
  const int hi = m - 1 < t ? m - 1 : t;
  return {lo, hi - lo + 1, t - lo, n - lo - (m - 1 - hi)};
}

// Outputs LO..HI of one column of a strip: output r takes the sorted row
// segments r .. r + KH - 1 (each of B values). `core` holds the kept ranks
// of the segments all of LO..HI share; the windows want rank T of N values.
template <int KH, int R, int B, int LO, int HI, int M, int T, int N, typename V>
__host__ __device__ __forceinline__ void tree(const Vec<B, V> (&rows)[R + KH - 1], const Vec<M, V>& core,
                                              V (&med)[R]);

template <int KH, int R, int B, int A, int Z, int E0, int E1, int M, int T, int N, typename V>
__host__ __device__ __forceinline__ void child(const Vec<B, V> (&rows)[R + KH - 1], const Vec<M, V>& core,
                                               V (&med)[R]) {
  constexpr Keep kx = keep((E1 - E0) * B, T, N);
  const Vec<kx.count, V> extra = slice<kx.count, kx.lo>(merge_range<B, E0, E1>(rows));
  if constexpr (A == Z) {
    static_assert(M + kx.count == kx.n, "a leaf holds its whole window");
    med[A] = select<M, kx.count, kx.t>(core, extra);
  } else {
    constexpr Keep kc = keep(M + kx.count, kx.t, kx.n);
    tree<KH, R, B, A, Z, kc.count, kc.t, kc.n>(rows, slice<kc.count, kc.lo>(merge(core, extra)), med);
  }
}

template <int KH, int R, int B, int LO, int HI, int M, int T, int N, typename V>
__host__ __device__ __forceinline__ void tree(const Vec<B, V> (&rows)[R + KH - 1], const Vec<M, V>& core,
                                              V (&med)[R]) {
  if constexpr (LO == HI) {
    static_assert(M == N, "a leaf holds its whole window");
    med[LO] = core[T];
  } else {
    constexpr int MID = (LO + HI) / 2;
    // Each half's shared segments, less the ones `core` already holds
    // (none, when the half is too long to share any).
    constexpr int LEFT_END = max_of(MID, HI < LO + KH ? HI : LO + KH);
    constexpr int RIGHT_BEGIN = HI > LO + KH ? HI : LO + KH;
    constexpr int RIGHT_END = max_of(RIGHT_BEGIN, MID + 1 + KH);
    child<KH, R, B, LO, MID, MID, LEFT_END, M, T, N>(rows, core, med);
    child<KH, R, B, MID + 1, HI, RIGHT_BEGIN, RIGHT_END, M, T, N>(rows, core, med);
  }
}

// The medians of an R x 2 strip of outputs from its (R + KH - 1) x (KW + 1)
// window x: med[c][r] is the median of x[r .. r + KH - 1][c .. c + KW - 1].
template <int KH, int KW, int R, typename V>
__host__ __device__ __forceinline__ void strip_medians(const V (&x)[R + KH - 1][KW + 1], V (&med)[2][R]) {
  Vec<KW, V> rows[2][R + KH - 1];
#pragma unroll
  for (int i = 0; i < R + KH - 1; ++i) {
    Vec<1, V> e[KW + 1];
#pragma unroll
    for (int j = 0; j < KW + 1; ++j) e[j][0] = x[i][j];
    const Vec<KW - 1, V> shared = merge_range<1, 1, KW>(e);
    rows[0][i] = merge(shared, e[0]);
    rows[1][i] = merge(shared, e[KW]);
  }
  constexpr int N = KH * KW;
  constexpr int ROOT_END = KH > R - 1 ? KH : R - 1;  // segments R - 1 .. KH - 1 are in every window
  constexpr Keep k = keep((ROOT_END - (R - 1)) * KW, N / 2, N);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const Vec<k.count, V> core = slice<k.count, k.lo>(merge_range<KW, R - 1, ROOT_END>(rows[c]));
    tree<KH, R, KW, 0, R - 1, k.count, k.t, k.n>(rows[c], core, med[c]);
  }
}

// strip_medians of float64 taps by the F64 network, with NaN carried beside
// it: an output whose window holds a NaN is NaN. The network's comparisons
// are false on NaN, so a node that holds one may hold it out of order, lose
// it or hold another value twice; but every node of the network holds only
// taps that every window reading it holds (the row segments and the tree's
// shared nodes), so only windows that hold the NaN read such a node, and the
// flag overrides exactly those. The flag is taken separably, as the network
// shares its segments: bit i of row_nan[c] is the OR over row i's taps of
// column c's windows, and output r tests the KH bits from bit r. (A bit
// mask, not an array of bools, keeps the 5x5 kernel at 210 registers
// without a spill.)
template <int KH, int KW, int R>
__host__ __device__ __forceinline__ void strip_medians_flagged(const double (&x)[R + KH - 1][KW + 1],
                                                               double (&med)[2][R]) {
  static_assert(R + KH - 1 <= 32, "a row's flag is one bit of a 32-bit mask");
  F64 y[R + KH - 1][KW + 1];
  unsigned row_nan[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < R + KH - 1; ++i) {
    bool shared = false;
#pragma unroll
    for (int j = 1; j < KW; ++j) shared |= x[i][j] != x[i][j];
    row_nan[0] |= static_cast<unsigned>(shared || x[i][0] != x[i][0]) << i;
    row_nan[1] |= static_cast<unsigned>(shared || x[i][KW] != x[i][KW]) << i;
#pragma unroll
    for (int j = 0; j < KW + 1; ++j) y[i][j].v = x[i][j];
  }
  F64 m[2][R];
  strip_medians<KH, KW, R>(y, m);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      med[c][r] = (row_nan[c] >> r) & ((1u << KH) - 1) ? static_cast<double>(NAN) : m[c][r].v;
    }
  }
}

// ---- Kernels ---------------------------------------------------------------

}  // namespace

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdio>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use on Hopper

// The element types, by the code the wrapper passes (kernels/highpass.py:
// DTYPE_CODES). A tile is loaded in its type T and its network runs on
// Compute<T>: float for float32, float16 and bfloat16 (the widening is exact
// and keeps order and NaN), double for float64. The difference is taken in
// that type and rounded once to T at the store, as the plain version's
// (x.float() - median.float()).to(T).
enum Dtype { kFloat32 = 0, kFloat64 = 1, kFloat16 = 2, kBFloat16 = 3 };

template <typename T>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(double* dst, double x) { *dst = x; }
__device__ __forceinline__ void store(__half* dst, float x) { *dst = __float2half_rn(x); }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// The staged 16-bit kernel's packed value (two tiles' pixels a register),
// and the tiles one work item of separable_kernel<..., T> takes: two for
// 16-bit tiles, one for the others.
template <typename T>
struct Packed;
template <>
struct Packed<__half> {
  using type = F16x2;
};
template <>
struct Packed<__nv_bfloat16> {
  using type = Bf16x2;
};

template <typename T>
__host__ __device__ constexpr int lanes() {
  return sizeof(T) == 2 ? 2 : 1;
}

// Lane k of a packed value, widened to float (exact).
__device__ __forceinline__ float lane(Bf16x2 p, int k) { return __uint_as_float(k ? p.bits & 0xffff0000u : p.bits << 16); }
__device__ __forceinline__ float lane(F16x2 p, int k) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(k ? p.bits >> 16 : p.bits)));
}

// Strip height of the separable kernels for T, from a window's float32 one
// r and staged float64 one r64 (GLIMPSE_SEPARABLE_WINDOWS): r for float32
// and 16 bits; r64 for the staged float64 kernel; half of r for the global
// float64 kernel, whose compare-and-select network takes more registers.
template <typename T>
constexpr int strip_rows(int r, int r64, bool global) {
  return sizeof(T) != 8 ? r : (global ? (r / 2 > 1 ? r / 2 : 1) : r64);
}

// Symmetric reflection into [0, n): -i - 1 below 0, 2n - 1 - i from n on;
// 0 from 2n on, where only rows that feed unstored outputs land.
__device__ __forceinline__ int reflect(int i, int n) { return max(min(max(i, ~i), 2 * n - 1 - i), 0); }

// Symmetric reflection of any index: period 2n, the second half mirrored,
// as numpy's mode="symmetric" pads an axis by more than its length.
__device__ __forceinline__ int reflect_periodic(int i, int n) {
  const int m = (i % (2 * n) + 2 * n) % (2 * n);
  return m < n ? m : 2 * n - 1 - m;
}

// reflect_periodic on a thin tile's route, reflect on every other.
template <bool kFold>
__device__ __forceinline__ int reflect_index(int i, int n) {
  if constexpr (kFold) {
    return reflect_periodic(i, n);
  } else {
    return reflect(i, n);
  }
}

// One element into shared memory by cp.async, which copies 4, 8 or 16
// bytes: a 2-byte element goes in the 4-byte word that holds it (dst and src
// lie at the same offset modulo 16 bytes), so the element beside it comes
// along, into the buffer's slack where it lies outside the range staged. A
// plain copy would stall its warp on the load, and the block at the next
// barrier.
template <typename T>
__device__ __forceinline__ void copy_element(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(sizeof(T)) : "memory");
  } else {
    const unsigned low = static_cast<unsigned>(reinterpret_cast<unsigned long long>(src) & 3);
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst)) - low;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(reinterpret_cast<const char*>(src) - low)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// Elements of one staging buffer for `elems` values of T, with V = 16 /
// sizeof(T) elements to a 16-byte line: V - 1 of slack so a group can sit at
// the same offset modulo 16 bytes as in device memory, rounded up to V.
template <typename T>
__host__ __device__ __forceinline__ int buffer_elements(int elems) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return (elems + 2 * (V - 1)) & ~(V - 1);
}

// Copy `count` elements from src + start into the buffer at dst_base, shifted
// by their address's offset modulo 16 bytes; returns that shift in elements.
// The 16-byte lines between go by cp.async; the elements before the first
// and after the last by copy_element, which for 2-byte elements may also
// write the element just before the range or just after it, in the slack.
template <typename T>
__device__ __forceinline__ int stage(T* dst_base, const T* src, long long start, int count) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const T* from = src + start;
  const int shift = static_cast<int>((reinterpret_cast<unsigned long long>(from) / sizeof(T)) & (V - 1));
  T* dst = dst_base + shift;
  const int head = min((V - shift) & (V - 1), count);
  const int body = (count - head) / V;
  for (int e = threadIdx.x; e < head; e += blockDim.x) copy_element(dst + e, from + e);
  for (int k = threadIdx.x; k < body; k += blockDim.x) cp_async16(dst + head + V * k, from + head + V * k);
  for (int e = head + V * body + threadIdx.x; e < count; e += blockDim.x) copy_element(dst + e, from + e);
  return shift;
}

// One element of a tile: from shared memory on the staged routes, from
// device memory through the read-only cache on the global ones.
template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The R x 2 strip of outputs whose top-left pixel is (y0, x0), of one h x w
// tile read from `src` and written to `dst`, its window reflected at the
// tile's own edges.
template <int KH, int KW, int R, bool kGlobal, typename T>
__device__ __forceinline__ void separable_strip(const T* src, T* dst, int h, int w, int y0, int x0) {
  using C = typename Compute<T>::type;
  int cols[KW + 1];
#pragma unroll
  for (int j = 0; j < KW + 1; ++j) cols[j] = reflect(x0 - KW / 2 + j, w);
  C x[R + KH - 1][KW + 1];
#pragma unroll
  for (int i = 0; i < R + KH - 1; ++i) {
    const T* row = src + reflect(y0 - KH / 2 + i, h) * w;
#pragma unroll
    for (int j = 0; j < KW + 1; ++j) x[i][j] = widen(load<kGlobal>(row + cols[j]));
  }
  C med[2][R];
  if constexpr (sizeof(T) == 8 && !kGlobal) {
    strip_medians_flagged<KH, KW, R>(x, med);
  } else {
    strip_medians<KH, KW, R>(x, med);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (x0 + c < w) store(dst + y * w + x0 + c, x[r + KH / 2][c + KW / 2] - med[c][r]);
    }
  }
}

// separable_strip of two 16-bit tiles at once, on the staged route: each
// tap packs the pixel at one (y, x) of tile a and of tile b into one
// register, so the two share every index and branch, and each min or max of
// the network selects in both. Selection in 16 bits is exact; each lane's
// difference is taken in float and rounded once, as separable_strip's. A
// tile with no partner passes b = a and dst_b = nullptr: lane b repeats
// lane a and is not stored.
template <int KH, int KW, int R, typename T>
__device__ __forceinline__ void packed_strip(const T* a, const T* b, T* dst_a, T* dst_b, int h, int w, int y0,
                                             int x0) {
  using P = typename Packed<T>::type;
  int cols[KW + 1];
#pragma unroll
  for (int j = 0; j < KW + 1; ++j) cols[j] = reflect(x0 - KW / 2 + j, w);
  P x[R + KH - 1][KW + 1];
#pragma unroll
  for (int i = 0; i < R + KH - 1; ++i) {
    const int row = reflect(y0 - KH / 2 + i, h) * w;
#pragma unroll
    for (int j = 0; j < KW + 1; ++j) {
      const unsigned lo = *reinterpret_cast<const unsigned short*>(a + row + cols[j]);
      const unsigned hi = *reinterpret_cast<const unsigned short*>(b + row + cols[j]);
      x[i][j].bits = __byte_perm(lo, hi, 0x5410);
    }
  }
  P med[2][R];
  strip_medians<KH, KW, R>(x, med);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (x0 + c < w) {
        const P centre = x[r + KH / 2][c + KW / 2];
        store(dst_a + y * w + x0 + c, lane(centre, 0) - lane(med[c][r], 0));
        if (dst_b != nullptr) store(dst_b + y * w + x0 + c, lane(centre, 1) - lane(med[c][r], 1));
      }
    }
  }
}

template <int KH, int KW, int R, typename T>
__global__ void __launch_bounds__(kThreads) separable_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                             int n, int h, int w, int per_block, int groups) {
  extern __shared__ __align__(16) unsigned char glimpse_smem[];
  T* smem = reinterpret_cast<T*>(glimpse_smem);
  const int tile = h * w;
  const int strips = (h + R - 1) / R;
  const int pairs = (w + 1) / 2;
  const int per_tile = strips * pairs;
  const long long total = static_cast<long long>(n) * tile;
  const int stride = buffer_elements<T>(per_block * tile);
  constexpr int L = lanes<T>();
  const int slots = (per_block + L - 1) / L;  // work items' tiles: L a slot
  auto count_of = [&](int g) {
    const long long start = static_cast<long long>(g) * per_block * tile;
    return static_cast<int>(min(static_cast<long long>(per_block) * tile, total - start));
  };

  int shift[2];
  shift[0] = stage(smem, in, static_cast<long long>(blockIdx.x) * per_block * tile, count_of(blockIdx.x));
  asm volatile("cp.async.commit_group;" ::: "memory");
  int buf = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, buf ^= 1) {
    const int next = g + gridDim.x;
    if (next < groups) {
      shift[buf ^ 1] = stage(smem + (buf ^ 1) * stride, in, static_cast<long long>(next) * per_block * tile,
                             count_of(next));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();

    const T* group = smem + buf * stride + shift[buf];
    for (int item = threadIdx.x; item < slots * per_tile; item += blockDim.x) {
      const int slot = item / per_tile;
      const long long t = static_cast<long long>(g) * per_block + L * slot;
      if (t >= n) break;
      const int rest = item - slot * per_tile;
      const int s = rest / pairs;
      const int y0 = s * R;
      const int x0 = 2 * (rest - s * pairs);
      const T* a = group + L * slot * tile;
      if constexpr (L == 1) {
        separable_strip<KH, KW, R, false>(a, out + t * tile, h, w, y0, x0);
      } else {
        const bool pair = L * slot + 1 < per_block && t + 1 < n;
        packed_strip<KH, KW, R>(a, pair ? a + tile : a, out + t * tile, pair ? out + (t + 1) * tile : nullptr, h, w,
                                y0, x0);
      }
    }
    __syncthreads();  // the next pass copies into the buffer just read
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Bytes of generic_kernel's tap offsets (S ints), rounded up to a whole
// element of T so the padded tile after them is aligned.
template <typename T>
__host__ __device__ constexpr int offset_bytes(int s) {
  return (4 * s + static_cast<int>(sizeof(T)) - 1) / static_cast<int>(sizeof(T)) * static_cast<int>(sizeof(T));
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads) generic_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                           int h, int w, int kh, int kw) {
  using C = typename Compute<T>::type;
  extern __shared__ __align__(16) unsigned char glimpse_smem[];
  int* offsets = reinterpret_cast<int*>(glimpse_smem);
  T* window = reinterpret_cast<T*>(glimpse_smem + offset_bytes<T>(S));
  const int ph = kh / 2;
  const int pw = kw / 2;
  const int ih = h + kh - 1;
  const int iw = w + kw - 1;
  const int taps = kh * kw;
  const size_t base = static_cast<size_t>(blockIdx.x) * h * w;
  const T* tile = in + base;
  for (int k = threadIdx.x; k < ih * iw; k += blockDim.x) {
    const int r = reflect(k / iw - ph, h);
    const int c = reflect(k % iw - pw, w);
    window[k] = tile[r * w + c];
  }
  for (int q = threadIdx.x; q < taps; q += blockDim.x) offsets[q] = (q / kw) * iw + q % kw;
  __syncthreads();

  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const int y = p / w;
    const int x = p - y * w;
    const T* corner = window + y * iw + x;
    Vec<S, C> v;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      // Past the taps: -inf, +inf, -inf, ... (an even count: S and taps are odd).
      v[t] = t < taps ? widen(corner[offsets[t]]) : ((t - taps) % 2 ? C(INFINITY) : C(-INFINITY));
    }
    store(out + base + p, widen(corner[ph * iw + pw]) - sort(v)[S / 2]);
  }
}

// The global routes: a thread a strip of separable_kernel's shape, or a
// pixel of generic_kernel's, over every tile of the stack (a grid-stride
// loop), each window read from device memory; generic_global_kernel with
// kFold is the thin tiles' route.
template <int KH, int KW, int R, typename T>
__global__ void __launch_bounds__(kThreads) separable_global_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                                    int n, int h, int w) {
  const long long tile = static_cast<long long>(h) * w;
  const int pairs = (w + 1) / 2;
  const long long per_tile = static_cast<long long>((h + R - 1) / R) * pairs;
  const long long items = per_tile * n;
  for (long long item = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; item < items;
       item += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = item / per_tile;
    const int rest = static_cast<int>(item - t * per_tile);
    const int s = rest / pairs;
    separable_strip<KH, KW, R, true>(in + t * tile, out + t * tile, h, w, s * R, 2 * (rest - s * pairs));
  }
}

template <int S, typename T, bool kFold>
__global__ void __launch_bounds__(kThreads) generic_global_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                                  int n, int h, int w, int kh, int kw) {
  using C = typename Compute<T>::type;
  const int taps = kh * kw;
  const long long tile = static_cast<long long>(h) * w;
  const long long pixels = tile * n;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < pixels;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = p / tile;
    const int q = static_cast<int>(p - t * tile);
    const int y = q / w;
    const int x = q - y * w;
    const T* src = in + t * tile;
    // Tap k is window row k / kw, column k % kw, as generic_kernel's offsets.
    Vec<S, C> v;
    int dr = 0, dc = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k < taps) {
        v[k] = widen(load<true>(src + reflect_index<kFold>(y - kh / 2 + dr, h) * w +
                                reflect_index<kFold>(x - kw / 2 + dc, w)));
        if (++dc == kw) {
          dc = 0;
          ++dr;
        }
      } else {
        v[k] = (k - taps) % 2 ? C(INFINITY) : C(-INFINITY);
      }
    }
    store(out + p, widen(load<true>(src + q)) - sort(v)[S / 2]);
  }
}

// ---- Dispatch --------------------------------------------------------------

// How many blocks of `kernel` the card holds at once.
int blocks_per_card(const void* kernel, int threads, int smem) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return (per_sm > 0 ? per_sm : 1) * sms;
}

// Whether one tile is staged whole in one block's shared memory: by
// separable_kernel (two buffers; the first test keeps a large tile's
// element count from overflowing int) or by generic_kernel<s> (the tap
// offsets and the padded tile). A tile that is not takes the global route.
template <typename T>
bool stages_separable(int h, int w) {
  return static_cast<long long>(h) * w * static_cast<long long>(sizeof(T)) <= kSmemLimit &&
         2 * buffer_elements<T>(h * w) * static_cast<int>(sizeof(T)) <= kSmemLimit;
}

template <typename T>
bool stages_generic(int s, int h, int w, int kh, int kw) {
  return offset_bytes<T>(s) + static_cast<long long>(h + kh - 1) * (w + kw - 1) * static_cast<long long>(sizeof(T)) <=
         kSmemLimit;
}

// The padded tap count generic_kernel<S> takes for kh * kw taps.
int generic_size(int kh, int kw) { return kh * kw <= 9 ? 9 : (kh * kw <= 25 ? 25 : 49); }

// A grid-stride launch of a global-route kernel over `items` threads' work:
// enough blocks to cover them, at most as many as the card holds at once.
template <typename Kernel, typename... Args>
cudaError_t launch_global(Kernel kernel, long long items, cudaStream_t stream, Args... args) {
  const long long needed = (items + kThreads - 1) / kThreads;
  const int card = blocks_per_card(reinterpret_cast<const void*>(kernel), kThreads, 0);
  kernel<<<static_cast<int>(needed < card ? needed : card), kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

// The windows the separable kernels are compiled for, each with its strip
// height R for float32 and 16 bits (8 rows where the registers allow, 4 for
// the larger windows) and R64 for the staged float64 kernel (strip_rows).
#define GLIMPSE_SEPARABLE_WINDOWS(X) X(3, 3, 8, 4) X(5, 5, 8, 4) X(7, 7, 4, 2) X(3, 7, 8, 4) X(9, 5, 4, 2)

template <int KH, int KW, int R, typename T>
cudaError_t launch_separable_global(const T* in, T* out, int n, int h, int w, cudaStream_t stream) {
  const long long per_tile = static_cast<long long>((h + R - 1) / R) * ((w + 1) / 2);
  return launch_global(separable_global_kernel<KH, KW, R, T>, n * per_tile, stream, in, out, n, h, w);
}

template <int KH, int KW, int R, typename T>
cudaError_t launch_separable(const T* in, T* out, int n, int h, int w, cudaStream_t stream) {
  constexpr int L = lanes<T>();
  const int per_tile = ((h + R - 1) / R) * ((w + 1) / 2);
  int per_block = L * (per_tile >= kThreads ? 1 : kThreads / per_tile);
  auto smem_of = [&](int g) { return 2 * buffer_elements<T>(g * h * w) * static_cast<int>(sizeof(T)); };
  while (per_block > 1 && smem_of(per_block) > kSmemLimit) --per_block;
  const int smem = smem_of(per_block);
  const auto kernel = separable_kernel<KH, KW, R, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int items = (per_block + L - 1) / L * per_tile;
  const int threads = items < kThreads ? items : kThreads;
  const int groups = (n + per_block - 1) / per_block;
  const int card = blocks_per_card(reinterpret_cast<const void*>(kernel), threads, smem);
  kernel<<<groups < card ? groups : card, threads, smem, stream>>>(in, out, n, h, w, per_block, groups);
  return cudaGetLastError();
}

template <int S, typename T>
cudaError_t launch_generic(const T* in, T* out, int n, int h, int w, int kh, int kw, bool global,
                           cudaStream_t stream) {
  if (global) {
    return launch_global(generic_global_kernel<S, T, false>, static_cast<long long>(n) * h * w, stream, in, out, n,
                         h, w, kh, kw);
  }
  const int smem = offset_bytes<T>(S) + (h + kh - 1) * (w + kw - 1) * static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(generic_kernel<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  generic_kernel<S, T><<<n, kThreads, smem, stream>>>(in, out, h, w, kh, kw);
  return cudaGetLastError();
}

// A thin tile's route: generic_global_kernel<S, T, true>, for any window.
template <typename T>
cudaError_t launch_thin(const T* in, T* out, int n, int h, int w, int kh, int kw, cudaStream_t stream) {
  const long long pixels = static_cast<long long>(n) * h * w;
  switch (generic_size(kh, kw)) {
    case 9: return launch_global(generic_global_kernel<9, T, true>, pixels, stream, in, out, n, h, w, kh, kw);
    case 25: return launch_global(generic_global_kernel<25, T, true>, pixels, stream, in, out, n, h, w, kh, kw);
    default: return launch_global(generic_global_kernel<49, T, true>, pixels, stream, in, out, n, h, w, kh, kw);
  }
}

// Whether a tile is thinner than half the window, so that its padding
// reflects more than once (7. above).
bool thin(int h, int w, int kh, int kw) { return h < kh / 2 + 1 || w < kw / 2 + 1; }

bool separable_window(int kh, int kw) {
#define GLIMPSE_IS(KH, KW, R, R64) \
  if (kh == KH && kw == KW) return true;
  GLIMPSE_SEPARABLE_WINDOWS(GLIMPSE_IS)
#undef GLIMPSE_IS
  return false;
}

// The routes: kAuto lets the launcher choose (takes_global); kStaged and
// kGlobal force one, for kernels/bench_highpass.py to time both on the same
// tiles. kStaged on a tile that does not fit, or on a thin one, is an
// invalid value; a thin tile takes launch_thin by kAuto and kGlobal.
enum Route { kAuto = 0, kStaged = 1, kGlobal = 2 };

template <typename T>
bool stages(int h, int w, int kh, int kw) {
  return separable_window(kh, kw) ? stages_separable<T>(h, w) : stages_generic<T>(generic_size(kh, kw), h, w, kh, kw);
}

// The work items of one tile: separable_kernel's strips, generic_kernel's
// pixels. A staged block has kThreads threads.
template <typename T>
long long tile_items(int h, int w, int kh, int kw) {
#define GLIMPSE_ITEMS(KH, KW, R, R64)                                                          \
  if (kh == KH && kw == KW)                                                                   \
    return static_cast<long long>((h + strip_rows<T>(R, R64, false) - 1) / strip_rows<T>(R, R64, false)) * \
           ((w + 1) / 2);
  GLIMPSE_SEPARABLE_WINDOWS(GLIMPSE_ITEMS)
#undef GLIMPSE_ITEMS
  return static_cast<long long>(h) * w;
}

// The route kAuto takes for a stack of n tiles: the global one for a tile
// that one block's shared memory cannot stage, and for a stack of fewer
// tiles than the card has SMs whose tiles each hold more work items than a
// block has threads. The staged route gives such a tile one block, which
// loops over it while SMs idle; the global one spreads it over the card.
// On an H100 (bench_highpass.py --routes): (1, 160, 160) 5x5 0.023 ms staged,
// 0.006 global; (2, 260, 260) 3x5 in bfloat16 0.81 and 0.008; the staged
// route stays the faster on many tiles, 0.120 against 0.133 ms at
// (20,480, 31, 31) 5x5 and 0.064 against 0.088 at (1,024, 31, 31) 7x5.
template <typename T>
bool takes_global(int n, int h, int w, int kh, int kw) {
  if (!stages<T>(h, w, kh, kw)) return true;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return n < sms && tile_items<T>(h, w, kh, kw) > kThreads;
}

template <typename T>
int launch(const void* in_ptr, void* out_ptr, int n, int h, int w, int kh, int kw, int route, cudaStream_t s) {
  const T* in = static_cast<const T*>(in_ptr);
  T* out = static_cast<T*>(out_ptr);
  if (thin(h, w, kh, kw)) {
    return static_cast<int>(route == kStaged ? cudaErrorInvalidValue : launch_thin<T>(in, out, n, h, w, kh, kw, s));
  }
  if (route == kStaged && !stages<T>(h, w, kh, kw)) return static_cast<int>(cudaErrorInvalidValue);
  const bool global = route == kGlobal || (route == kAuto && takes_global<T>(n, h, w, kh, kw));
#define GLIMPSE_LAUNCH(KH, KW, R, R64)                                                                      \
  if (kh == KH && kw == KW)                                                                                 \
    return static_cast<int>(global ? launch_separable_global<KH, KW, strip_rows<T>(R, R64, true), T>(in, out, n, h, w, s) \
                                   : launch_separable<KH, KW, strip_rows<T>(R, R64, false), T>(in, out, n, h, w, s));
  GLIMPSE_SEPARABLE_WINDOWS(GLIMPSE_LAUNCH)
#undef GLIMPSE_LAUNCH
  switch (generic_size(kh, kw)) {
    case 9: return static_cast<int>(launch_generic<9, T>(in, out, n, h, w, kh, kw, global, s));
    case 25: return static_cast<int>(launch_generic<25, T>(in, out, n, h, w, kh, kw, global, s));
    default: return static_cast<int>(launch_generic<49, T>(in, out, n, h, w, kh, kw, global, s));
  }
}

// The name of the kernel launch<T> runs, by kAuto, for this stack and window.
template <typename T>
void name_variant(char* name, int size, int n, int h, int w, int kh, int kw, const char* type) {
  if (thin(h, w, kh, kw)) {
    snprintf(name, size, "generic_folded<%d>[%s]", generic_size(kh, kw), type);
    return;
  }
  const bool global = takes_global<T>(n, h, w, kh, kw);
  const char* route = global ? "_global" : "";
  // The staged 16- and 64-bit kernels by their designs' names.
  const char* family = global ? "_global" : (sizeof(T) == 2 ? "_packed" : (sizeof(T) == 8 ? "_nanflag" : ""));
#define GLIMPSE_NAME(KH, KW, R, R64)                                                                            \
  if (kh == KH && kw == KW) {                                                                                  \
    snprintf(name, size, "separable%s<%d,%d,%d>[%s]", family, KH, KW, strip_rows<T>(R, R64, global), type);    \
    return;                                                                                                    \
  }
  GLIMPSE_SEPARABLE_WINDOWS(GLIMPSE_NAME)
#undef GLIMPSE_NAME
  snprintf(name, size, "generic%s<%d>[%s]", route, generic_size(kh, kw), type);
}

const char* dtype_name(int dtype) {
  switch (dtype) {
    case kFloat32: return "float32";
    case kFloat64: return "float64";
    case kFloat16: return "float16";
    case kBFloat16: return "bfloat16";
    default: return nullptr;
  }
}

}  // namespace

// The kernel glimpse_median_highpass_typed runs for a stack (n, h, w), a
// kh x kw window and an element type, as "separable<KH,KW,R>[type]" or
// "generic<S>[type]", with "_global" after the family on the global route
// and "_packed" (16 bits) or "_nanflag" (float64) after a staged separable
// kernel's, or "generic_folded<S>[type]" for a thin tile.
extern "C" const char* glimpse_median_highpass_variant_typed(int n, int h, int w, int kh, int kw, int dtype) {
  static thread_local char name[64];
  const char* type = dtype_name(dtype);
  switch (dtype) {
    case kFloat32: name_variant<float>(name, sizeof(name), n, h, w, kh, kw, type); break;
    case kFloat64: name_variant<double>(name, sizeof(name), n, h, w, kh, kw, type); break;
    case kFloat16: name_variant<__half>(name, sizeof(name), n, h, w, kh, kw, type); break;
    case kBFloat16: name_variant<__nv_bfloat16>(name, sizeof(name), n, h, w, kh, kw, type); break;
    default: return "unsupported";
  }
  return name;
}

// The high-pass of a stack of tiles of any of the four element types, by
// the route `route` names (a Route).
extern "C" int glimpse_median_highpass_route(const void* in, void* out, int n, int h, int w, int kh, int kw,
                                             int dtype, int route, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(in, out, n, h, w, kh, kw, route, s);
    case kFloat64: return launch<double>(in, out, n, h, w, kh, kw, route, s);
    case kFloat16: return launch<__half>(in, out, n, h, w, kh, kw, route, s);
    case kBFloat16: return launch<__nv_bfloat16>(in, out, n, h, w, kh, kw, route, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The high-pass by the route the launcher chooses.
extern "C" int glimpse_median_highpass_typed(const void* in, void* out, int n, int h, int w, int kh, int kw,
                                             int dtype, void* stream) {
  return glimpse_median_highpass_route(in, out, n, h, w, kh, kw, dtype, kAuto, stream);
}

extern "C" const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
