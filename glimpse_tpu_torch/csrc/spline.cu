// The exact cubic B-spline of a stack of surfaces at fractional indices:
// out[b, q] = sum over 16 taps of w_r * w_c * c[b, row tap, col tap], with the
// natural-boundary ghosts c[-1] = 2 c[0] - c[1] and c[n] = 2 c[n-1] - c[n-2]
// folded in on each axis. The tracker reads each point's SSE surface at each
// of its particles this way (track/batch.py:_read_spline, mode "einsum").
//
// Replaces no Pallas kernel: the reference reads the spline by XLA ops
// (glimpse_tpu/track/batch.py:_sample_sse_surface, a dense basis contracted
// on the MXU). The plain version is ops/sampling.py:bspline_sample, 16 taps
// of gathers and elementwise ops over (B, P) tensors; this kernel computes
// what that code computes on the card, bit for bit:
// - each axis's weights (1 - 3t + 3t^2 - t^3) / 6 and the others in the
//   plain version's order, in the coordinates' type X, and "/ 6" as
//   PyTorch's CUDA division by a host scalar does it, a product with the
//   reciprocal of 6 rounded to X;
// - the tap index floor(x) + d, d in -1..2, as int64 (Tensor.long(): the
//   float-to-int conversion saturates, the addition wraps), a tap below 0
//   folded to (0, min(1, n - 1)) and one beyond n - 1 to (n - 1,
//   max(n - 2, 0)) with weights (2, -1), an inside tap to (i, i) with (1, 0);
// - a tap's value ((w0 w0') c00 + (w0 w1') c01) + (w1 w0') c10 + (w1 w1') c11
//   with the fold's weights in float32 (torch.where of Python numbers), in
//   float32 for float32 and 16-bit coefficients T and in float64 for float64;
// - out = out + (w_r w_c) * value in the order (row tap, column tap), w_r w_c
//   in X, the sum in float32, or float64 where T or X is float64. So 16-bit
//   surfaces give a float32 output, as the plain version's promotions do.
//   No FMA: every product and sum is an explicit _rn intrinsic, which the
//   compiler never contracts.
// T is any of float32, float64, float16 and bfloat16, X float32 or float64:
// the tracker's coordinates are its float32 camera's projections, or wider
// (float64 particles), so 16-bit surfaces are read at float32 coordinates.
// A tap's value depends only on which slot (below the grid, a cell, beyond
// it) its row and its column index fall in, so a block computes the folded
// values of its surface once, exactly as above, at tap indices -1 to n + 1
// on each axis ((h + 3) x (w + 3), the last two alike), and each particle
// reads its 16 taps from that table: a particle whose floor lies on the grid
// (every particle the tracker reads, which it clamps to the grid) as the 4 x
// 4 block at its floor, any other through each tap's slot. Inside the grid
// the four-term value is c + 0 c: the cell itself, or NaN where the cell is
// +-inf, as the plain version gives.
//
// What bounds it on the card: bytes. A particle reads two coordinates and
// writes one value (12 bytes in float32); a surface's coefficients are read
// once for 2,048 particles. At the north star's (20,480, 17, 17) x 2,048 that
// is 527 MB, 0.157 ms at 3.35 TB/s; the arithmetic (about 60 float32 ops and
// 16 shared-memory reads a particle) stays under it. The design:
// - one surface a block (a second grid axis splits a surface's particles
//   into chunks of kChunk, so a few surfaces of many particles still fill
//   the card); the folded table, 1.6 KB at 17 x 17 and 3.6 KB at 27 x 27 in
//   float32, lives in shared memory, so many blocks fit an SM and the 16
//   taps are shared-memory reads at constant offsets from one address;
// - the coordinates stream in coalesced loads, kUnroll particles a thread
//   loaded before any is computed, so enough bytes are in flight to keep
//   device memory busy; the output is written coalesced;
// - each particle's 4 + 4 weights are computed once, not once a tap.
// A surface whose table exceeds a block's shared memory (more than about
// 238 x 238 cells in float32, 167 x 167 in float64) takes the same kernel
// with its taps folded from device memory (through L1) at each read: the
// same arithmetic, slower.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = 2048;        // particles a block takes from one surface
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use on Hopper

// The element types, by the code the wrapper passes (kernels/spline.py:
// DTYPE_CODES), as csrc/highpass.cu numbers them.
enum Dtype { kFloat32 = 0, kFloat64 = 1, kFloat16 = 2, kBFloat16 = 3 };

// The type PyTorch computes an op on T tensors in: float for the 16-bit
// types and float32, double for float64. It is also the type of a tap's
// value (the fold's float32 weights times a T coefficient).
template <typename T>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};

// The output's type: the wider of the taps' and the weights' computing types.
template <typename A, typename B>
struct Wider {
  using type = double;
};
template <>
struct Wider<float, float> {
  using type = float;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return ::floor(x); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The four weights of one coordinate x of type X, float or double
// (sampling._cubic_bspline_weights of x - floor(x)), and floor(x).
template <typename X>
__device__ __forceinline__ X axis_weights(X x, X w[4]) {
  const X base = floor_of(x);
  const X inv6 = X(1) / X(6);
  const X t = sub(x, base);
  const X t2 = mul(t, t);
  const X t3 = mul(t2, t);
  const X t_3 = mul(t, X(3));
  const X t2_3 = mul(t2, X(3));
  const X t3_3 = mul(t3, X(3));
  w[0] = mul(sub(add(sub(X(1), t_3), t2_3), t3), inv6);
  w[1] = mul(add(sub(X(4), mul(t2, X(6))), t3_3), inv6);
  w[2] = mul(sub(add(add(t_3, X(1)), t2_3), t3_3), inv6);
  w[3] = mul(t3, inv6);
  return base;
}

// The slot of tap base + d on an axis of n cells: 0 below the grid, i + 1
// for cell i, n + 1 beyond it. The int64 addition wraps as PyTorch's does.
__device__ __forceinline__ int slot(long long base, int d, int n) {
  const long long i = static_cast<long long>(static_cast<unsigned long long>(base) + static_cast<unsigned long long>(d));
  return i < 0 ? 0 : (i > n - 1 ? n + 1 : static_cast<int>(i) + 1);
}

// sampling._natural_index of a slot: cells i0, i1 and weights w0, w1.
struct Fold {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Fold fold(int s, int n) {
  if (s == 0) return {0, min(1, n - 1), 2.0f, -1.0f};
  if (s > n) return {n - 1, max(n - 2, 0), 2.0f, -1.0f};
  return {s - 1, s - 1, 1.0f, 0.0f};
}

// The folded value of slots (sr, sc) of the surface c (h x w).
template <typename T>
__device__ __forceinline__ typename Compute<T>::type folded(const T* __restrict__ c, int h, int w, int sr, int sc) {
  using C = typename Compute<T>::type;
  const Fold r = fold(sr, h);
  const Fold k = fold(sc, w);
  const C v00 = mul(C(__fmul_rn(r.w0, k.w0)), widen(c[r.i0 * w + k.i0]));
  const C v01 = mul(C(__fmul_rn(r.w0, k.w1)), widen(c[r.i0 * w + k.i1]));
  const C v10 = mul(C(__fmul_rn(r.w1, k.w0)), widen(c[r.i1 * w + k.i0]));
  const C v11 = mul(C(__fmul_rn(r.w1, k.w1)), widen(c[r.i1 * w + k.i1]));
  return add(add(add(v00, v01), v10), v11);
}

// The 16 taps in the plain version's order: tap(dr, dc) gives the folded
// value of row tap dr and column tap dc.
template <typename X, typename O, typename Tap>
__device__ __forceinline__ O sum_taps(const X wr[4], const X wc[4], Tap tap) {
  O out = O(0);
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
#pragma unroll
    for (int dc = 0; dc < 4; ++dc) out = add(out, mul(O(mul(wr[dr], wc[dc])), O(tap(dr, dc))));
  }
  return out;
}

// One particle at (row, col). table: the surface's folded values, tw a row,
// or null to fold each tap from c. A particle whose floor lies on the grid
// on both axes (every particle the tracker reads: it clamps them to it)
// reads its 4 x 4 taps as a block of the table; any other takes each tap's
// slot from its int64 index.
template <typename T, typename X, typename O>
__device__ __forceinline__ O spline_at(X row, X col, const T* __restrict__ c, const typename Compute<T>::type* table,
                                       int h, int w, int tw) {
  X wr[4], wc[4];
  const X rf = axis_weights(row, wr);
  const X cf = axis_weights(col, wc);
  if (table != nullptr && rf >= X(0) && rf <= X(h - 1) && cf >= X(0) && cf <= X(w - 1)) {
    const auto* corner = table + static_cast<int>(rf) * tw + static_cast<int>(cf);
    return sum_taps<X, O>(wr, wc, [&](int dr, int dc) { return corner[dr * tw + dc]; });
  }
  const long long rb = static_cast<long long>(rf);
  const long long cb = static_cast<long long>(cf);
  int sr[4], sc[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    sr[d] = slot(rb, d - 1, h);
    sc[d] = slot(cb, d - 1, w);
  }
  return sum_taps<X, O>(wr, wc, [&](int dr, int dc) {
    return table != nullptr ? table[sr[dr] * tw + sc[dc]] : folded(c, h, w, sr[dr], sc[dc]);
  });
}

// Block (b, y) reads surface b (coefficients of type T) at its particles
// [y * kChunk, (y + 1) * kChunk) of p (coordinates of type X). Staged: the
// folded table in shared memory; otherwise each tap folded from device
// memory.
template <typename T, typename X, bool Staged>
__global__ void __launch_bounds__(kThreads) spline_sample_kernel(
    const T* __restrict__ coeffs, const X* __restrict__ rows, const X* __restrict__ cols,
    typename Wider<typename Compute<T>::type, X>::type* __restrict__ out, int h, int w, int p) {
  using C = typename Compute<T>::type;
  using O = typename Wider<C, X>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  C* table = reinterpret_cast<C*>(smem);
  const T* c = coeffs + static_cast<size_t>(blockIdx.x) * h * w;
  const int tw = w + 3;
  if (Staged) {
    for (int k = threadIdx.x; k < (h + 3) * tw; k += kThreads) table[k] = folded(c, h, w, k / tw, k % tw);
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * p;
  const int end = min(p, static_cast<int>(blockIdx.y + 1) * kChunk);
  for (int first = static_cast<int>(blockIdx.y) * kChunk + threadIdx.x; first < end; first += kUnroll * kThreads) {
    X r[kUnroll], q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = first + u * kThreads;
      if (i < end) {
        r[u] = rows[base + i];
        q[u] = cols[base + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = first + u * kThreads;
      if (i < end) out[base + i] = spline_at<T, X, O>(r[u], q[u], c, Staged ? table : nullptr, h, w, tw);
    }
  }
}

template <typename T>
size_t table_bytes(int h, int w) {
  return static_cast<size_t>(h + 3) * (w + 3) * sizeof(typename Compute<T>::type);
}

template <typename T>
bool staged(int h, int w) {
  return table_bytes<T>(h, w) <= static_cast<size_t>(kSmemLimit);
}

template <typename T, typename X>
int launch(const void* coeffs, const void* rows, const void* cols, void* out, long long b, int h, int w, int p,
           cudaStream_t stream) {
  using O = typename Wider<typename Compute<T>::type, X>::type;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b), (p + kChunk - 1) / kChunk);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const T* c = static_cast<const T*>(coeffs);
  const X* r = static_cast<const X*>(rows);
  const X* q = static_cast<const X*>(cols);
  O* o = static_cast<O*>(out);
  if (staged<T>(h, w)) {
    const int smem = static_cast<int>(table_bytes<T>(h, w));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(spline_sample_kernel<T, X, true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    spline_sample_kernel<T, X, true><<<grid, kThreads, smem, stream>>>(c, r, q, o, h, w, p);
  } else {
    spline_sample_kernel<T, X, false><<<grid, kThreads, 0, stream>>>(c, r, q, o, h, w, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coords(const void* coeffs, const void* rows, const void* cols, void* out, long long b, int h, int w,
                  int p, int coords, cudaStream_t s) {
  switch (coords) {
    case kFloat32: return launch<T, float>(coeffs, rows, cols, out, b, h, w, p, s);
    case kFloat64: return launch<T, double>(coeffs, rows, cols, out, b, h, w, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The spline of b surfaces (h, w) at b x p coordinates: coefficients of type
// `dtype` and coordinates of type `coords` (Dtype codes; coordinates float32
// or float64); out is float64 where either is float64, else float32.
extern "C" int glimpse_spline_sample(const void* coeffs, const void* rows, const void* cols, void* out, long long b,
                                     int h, int w, int p, int dtype, int coords, void* stream) {
  if (b == 0 || p == 0) return static_cast<int>(cudaGetLastError());
  if (b < 0 || h < 1 || w < 1 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_coords<float>(coeffs, rows, cols, out, b, h, w, p, coords, s);
    case kFloat64: return launch_coords<double>(coeffs, rows, cols, out, b, h, w, p, coords, s);
    case kFloat16: return launch_coords<__half>(coeffs, rows, cols, out, b, h, w, p, coords, s);
    case kBFloat16: return launch_coords<__nv_bfloat16>(coeffs, rows, cols, out, b, h, w, p, coords, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// "staged" or "global": the route surfaces of (h, w) with coefficients of
// type `dtype` take.
extern "C" const char* glimpse_spline_route(int h, int w, int dtype) {
  bool in_shared;
  switch (dtype) {
    case kFloat32: in_shared = staged<float>(h, w); break;
    case kFloat64: in_shared = staged<double>(h, w); break;
    case kFloat16: in_shared = staged<__half>(h, w); break;
    case kBFloat16: in_shared = staged<__nv_bfloat16>(h, w); break;
    default: return "unsupported";
  }
  return in_shared ? "staged" : "global";
}

extern "C" const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
