// The tracker's observer front end for every observer in one launch: project
// each point's particles through each observer's camera, take the weighted
// mean projection, round and clamp the search box's corner, cut the search
// tile from the observer's image and write each particle's fractional index
// into the SSE surface (cols, rows). track/batch.py:observer_log_likelihoods_multi
// calls it once a step through kernels/project.py:project_extract.
//
// Replaces no Pallas kernel: the reference computes the front end by XLA ops
// (glimpse_tpu/track/batch.py, _project_and_extract). The plain version is
// kernels/project.py:project_extract_plain, each observer's projection planes
// (ops/projection.py:project_planes), weighted means, corners and tile gather,
// stacked observer-major by torch.cat. What this kernel computes against it:
// - the normalized weights w / sum(w), with the sum torch.sum gave (the
//   wrapper passes it: a 16-bit total summed in another order could round to
//   another value, and move every weight), the quotient rounded to the
//   particles' type D, and every particle's projection in
//   project_planes' operation order, in the type X that D and the float32
//   cameras promote to (float64 for float64 particles, else float32: 16-bit
//   particles widen to float32). Every product, sum and quotient is an
//   explicit _rn intrinsic, which nvcc never contracts into an FMA, and
//   camera-only terms (the rotation matrix of ops/projection.py:
//   rotation_matrix, imgsz / 2 + c) are computed in float32 first, as the
//   plain version's small camera tensors are. A particle at or behind the camera
//   plane (zc <= 0) projects to NaN, and NaN becomes -1e6 (+-inf the largest
//   finite X), as torch.nan_to_num(u, nan=-1e6) gives;
// - the elevation correction (refraction - 1) * d2 / (2 radius) as PyTorch's
//   CUDA ops compute it with host scalars: the first factor rounded to X's
//   computing type, the division a product with the reciprocal rounded to
//   it (the wrapper passes both);
// - the weighted means sum(u * w) and sum(v * w) as block reductions. Their
//   order differs from torch.sum's, so a mean may differ from the plain
//   version's by float rounding, and its corner (round half to even, then
//   clamped into the image) differs only where the plain mean lies within
//   that rounding of a half-pixel tie. Where the corners agree, the tiles
//   and cols and rows are bit-equal to the plain version's on the card:
//   cols = u - ((D(corner) + (tw / 2 - 1 / 2)) + duv_u) - 1 / 2, the first
//   sum rounded to D, the second to the template offsets' type.
//
// What bounds it on the card: bytes, with instruction issue close behind. A
// point's particles (24 B each in float32, of which x, y, z are read) and
// weights come in once for all observers; each observer's cols and rows (8 B
// a particle) and its tile go out once; the image (1-4 MB) stays in L2. At
// the north star (10,240 points of 2,048 particles, two observers, 31 x 31
// tiles) that is 751.9 MB counted once each, 0.2245 ms at 3.35 TB/s; the
// records' unread velocities share their 32-byte sectors, so the card reads
// about 1.0 GB. The arithmetic is some 100 instructions a particle and
// observer, three IEEE divisions among them (no FMA and no reciprocal: the
// plain version's roundings), 4.2 G at the north star, about 0.13 ms at the
// card's issue rate; a variant that projected every particle twice took 0.22
// ms longer. The design:
// - one block a point: its particles sit in registers (kPer a thread,
//   coalesced: thread t takes particles t, t + kThreads, ...), so each
//   observer's projection, mean and index planes never reach device memory;
// - three blocks an SM in float32 (80 registers a thread), so that some
//   blocks compute while others wait on memory; every observer's camera,
//   its rotation computed from (yaw, pitch, roll) as rotation_matrix does,
//   sits in shared memory, loaded while the particles are on their way;
// - each observer's two sums are one block reduction (warp shuffles, then a
//   shared-memory pass), after which every thread knows the corner; the
//   block copies the tile and writes cols and rows from registers;
// - more particles than a block holds (P > kChunk) are taken in chunks of
//   kChunk, read again (from L2) for each observer and for each of its two
//   passes: the same arithmetic, the same results.
// No allocation here: the wrapper allocates the outputs.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                     // particles a thread holds
constexpr int kChunk = kThreads * kPer;     // particles a block holds: 2,048
constexpr int kWarps = kThreads / 32;
constexpr int kMaxObservers = 64;

// The element types, by the code the wrapper passes (kernels/project.py:
// DTYPE_CODES), as csrc/spline.cu numbers them.
enum Dtype { kFloat32 = 0, kFloat64 = 1, kFloat16 = 2, kBFloat16 = 3 };

// The type PyTorch computes an op on D tensors in: float for the 16-bit types
// and float32, double for float64.
template <typename D>
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

// x rounded to D and widened back: D's value in its computing type.
template <typename D>
__device__ __forceinline__ typename Compute<D>::type round_to(typename Compute<D>::type x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float round_half_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_half_even(double x) { return rint(x); }
__device__ __forceinline__ float largest(float) { return 3.40282346638528859812e+38f; }
__device__ __forceinline__ double largest(double) { return 1.79769313486231570815e+308; }

// torch.nan_to_num(x, nan=-1e6): NaN to -1e6, +-inf to the largest finite value.
template <typename X>
__device__ __forceinline__ X nan_to_num(X x) {
  if (isnan(x)) return X(-1e6);
  if (isinf(x)) return x > X(0) ? largest(x) : -largest(x);
  return x;
}

// Each observer's elevation correction, by value: on[o] says whether it has
// one, scale[o] is (refraction - 1) and inverse[o] 1 / (2 radius), each
// already rounded to the computing type by the wrapper.
struct Corrections {
  double scale[kMaxObservers];
  double inverse[kMaxObservers];
  unsigned char on[kMaxObservers];
};

// One observer's camera in the computing type X: position, rotation (row
// major), distortion, focal lengths and imgsz / 2 + c, the camera-only terms
// computed in C.
template <typename X>
struct Camera {
  X xyz[3], r[9], k[6], p[2], f[2], center[2];
  bool corrected;
  X scale, inverse;
};

template <typename X>
__device__ __forceinline__ void load_camera(Camera<X>& cam, const float* __restrict__ cams, int o,
                                            const Corrections& corrections) {
  const float* v = cams + o * 20;
  // ops/projection.py:rotation_matrix of (yaw, pitch, roll) in degrees, in
  // its elementwise ops' order; PyTorch's cos and sin are cosf and sinf, as
  // here.
  float c[3], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float radians = mul(v[3 + i], float(M_PI / 180));
    c[i] = cosf(radians);
    s[i] = sinf(radians);
  }
  const float r[9] = {
      add(mul(c[0], c[2]), mul(mul(s[0], s[1]), s[2])), sub(mul(mul(c[0], s[1]), s[2]), mul(c[2], s[0])),
      mul(-c[1], s[2]),
      sub(mul(mul(c[2], s[0]), s[1]), mul(c[0], s[2])), add(mul(s[0], s[2]), mul(mul(c[0], c[2]), s[1])),
      mul(-c[1], c[2]),
      mul(c[1], s[0]), mul(c[0], c[1]), s[1],
  };
#pragma unroll
  for (int i = 0; i < 3; ++i) cam.xyz[i] = X(v[i]);
#pragma unroll
  for (int i = 0; i < 9; ++i) cam.r[i] = X(r[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) cam.k[i] = X(v[12 + i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cam.p[i] = X(v[18 + i]);
    cam.f[i] = X(v[8 + i]);
    cam.center[i] = X(add(mul(v[6 + i], 0.5f), v[10 + i]));
  }
  cam.corrected = corrections.on[o] != 0;
  cam.scale = X(corrections.scale[o]);
  cam.inverse = X(corrections.inverse[o]);
}

// ops/projection.py:project_planes of one particle, then nan_to_num.
template <typename X>
__device__ __forceinline__ void project(const Camera<X>& cam, X x, X y, X z, X& u, X& v) {
  const X dx = sub(x, cam.xyz[0]);
  const X dy = sub(y, cam.xyz[1]);
  X dz = sub(z, cam.xyz[2]);
  if (cam.corrected) dz = add(dz, mul(mul(cam.scale, add(mul(dx, dx), mul(dy, dy))), cam.inverse));
  const X xc = add(add(mul(cam.r[0], dx), mul(cam.r[1], dy)), mul(cam.r[2], dz));
  const X yc = add(add(mul(cam.r[3], dx), mul(cam.r[4], dy)), mul(cam.r[5], dz));
  const X zc = add(add(mul(cam.r[6], dx), mul(cam.r[7], dy)), mul(cam.r[8], dz));
  X xn, yn;
  if (zc <= X(0)) {
    xn = yn = X(NAN);
  } else {
    xn = quot(xc, zc);
    yn = quot(yc, zc);
  }
  const X r2 = add(mul(xn, xn), mul(yn, yn));
  const X r4 = mul(r2, r2);
  const X r6 = mul(r4, r2);
  const X num = add(add(add(mul(cam.k[0], r2), X(1)), mul(cam.k[1], r4)), mul(cam.k[2], r6));
  const X den = add(add(add(mul(cam.k[3], r2), X(1)), mul(cam.k[4], r4)), mul(cam.k[5], r6));
  const X dr = quot(num, den);
  const X xty = mul(xn, yn);
  const X dtx = add(mul(mul(X(2), xty), cam.p[0]), mul(cam.p[1], add(r2, mul(mul(X(2), xn), xn))));
  const X dty = add(mul(cam.p[0], add(r2, mul(mul(X(2), yn), yn))), mul(mul(X(2), xty), cam.p[1]));
  u = nan_to_num(add(mul(add(mul(xn, dr), dtx), cam.f[0]), cam.center[0]));
  v = nan_to_num(add(mul(add(mul(yn, dr), dty), cam.f[1]), cam.center[1]));
}

// The block's sums of a and b, the same in every thread: a warp butterfly
// (whose pairs add alike), then the warps' partial sums in warp order.
// `part` holds 2 x kWarps values; the closing barrier frees it for reuse.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* part) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    a = add(a, __shfl_xor_sync(0xffffffffu, a, offset));
    b = add(b, __shfl_xor_sync(0xffffffffu, b, offset));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[warp] = a;
    part[kWarps + warp] = b;
  }
  __syncthreads();
  a = part[0];
  b = part[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a = add(a, part[w]);
    b = add(b, part[kWarps + w]);
  }
  __syncthreads();
}

struct Args {
  const void* particles;  // (N, P, stride) of D
  const void* weights;    // (N, P) of D
  const void* totals;     // (N,) of D: torch.sum(weights, dim=-1)
  const void* cams;       // (O, 20) of float
  const void* duv;        // (O, N, 2) of D, or of X where duv_wide
  const void* images;     // (O, H, W), elements of image_bytes
  void* tiles;            // (O * N, sh, sw), as the images
  void* cols;             // (O * N, P) of X
  void* rows;             // (O * N, P) of X
  long long n;
  int o, p, stride, h, w, th, tw, sh, sw, image_bytes, duv_wide;
  Corrections corrections;
};

// The tile of image o at (row, col), (sh, sw) elements of type E, copied.
template <typename E>
__device__ __forceinline__ void copy_tile(const Args& a, int o, long long point, long long row, long long col) {
  const E* image = static_cast<const E*>(a.images) + static_cast<size_t>(o) * a.h * a.w;
  E* tile = static_cast<E*>(a.tiles) + static_cast<size_t>(point) * a.sh * a.sw;
  for (int e = threadIdx.x; e < a.sh * a.sw; e += kThreads) {
    const int r = e / a.sw;
    tile[e] = image[(row + r) * a.w + col + (e - r * a.sw)];
  }
}

// The blocks an SM must hold at once: three in float32 (80 registers a
// thread), so that some blocks project while others load; one in float64,
// whose registers would otherwise spill.
template <typename X>
constexpr int kMinBlocks = sizeof(X) == 4 ? 3 : 1;

template <typename D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<typename Compute<D>::type>)
    project_extract_kernel(const Args a) {
  using W = typename Compute<D>::type;
  using X = W;
  __shared__ X part[2 * kWarps];
  __shared__ Camera<X> camera[kMaxObservers];
  const long long n = blockIdx.x;
  const int t = threadIdx.x;
  const D* pw = static_cast<const D*>(a.weights) + n * a.p;
  const D* pp = static_cast<const D*>(a.particles) + n * a.p * a.stride;
  const int chunks = (a.p + kChunk - 1) / kChunk;

  D wr[kPer];
  X x[kPer], y[kPer], z[kPer], wn[kPer], u[kPer], v[kPer];
  // Chunk c's particles into registers: raw weights and x, y, z widened.
  auto load = [&](int c) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = c * kChunk + k * kThreads + t;
      if (i < a.p) {
        wr[k] = pw[i];
        x[k] = X(widen(pp[static_cast<size_t>(i) * a.stride]));
        y[k] = X(widen(pp[static_cast<size_t>(i) * a.stride + 1]));
        z[k] = X(widen(pp[static_cast<size_t>(i) * a.stride + 2]));
      }
    }
  };

  if (chunks == 1) load(0);
  // Every observer's camera into shared memory, one a thread, while the
  // particles are on their way.
  if (t < a.o) load_camera<X>(camera[t], static_cast<const float*>(a.cams), t, a.corrections);
  __syncthreads();
  const W denominator = widen(static_cast<const D*>(a.totals)[n]);
  auto normalize = [&]() {
#pragma unroll
    for (int k = 0; k < kPer; ++k) wn[k] = X(round_to<D>(quot(widen(wr[k]), denominator)));
  };
  if (chunks == 1) normalize();

  for (int o = 0; o < a.o; ++o) {
    const Camera<X>& cam = camera[o];
    X su = X(0), sv = X(0);
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) {
        load(c);
        normalize();
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (c * kChunk + k * kThreads + t < a.p) {
          project(cam, x[k], y[k], z[k], u[k], v[k]);
          su = add(su, mul(u[k], wn[k]));
          sv = add(sv, mul(v[k], wn[k]));
        }
      }
    }
    block_sum2(su, sv, part);
    // torch.round(mean - size / 2).long().clamp(0, extent - size); the
    // conversion saturates and takes NaN to 0, as on the card.
    const long long col = min(max(static_cast<long long>(round_half_even(sub(su, X(a.sw * 0.5)))), 0LL),
                              static_cast<long long>(a.w - a.sw));
    const long long row = min(max(static_cast<long long>(round_half_even(sub(sv, X(a.sh * 0.5)))), 0LL),
                              static_cast<long long>(a.h - a.sh));
    const long long point = static_cast<long long>(o) * a.n + n;
    switch (a.image_bytes) {
      case 2: copy_tile<uint16_t>(a, o, point, row, col); break;
      case 4: copy_tile<uint32_t>(a, o, point, row, col); break;
      default: copy_tile<uint64_t>(a, o, point, row, col); break;
    }
    // The SSE surface's origin: (D(corner) + (size / 2 - 1 / 2)) rounded to
    // D, plus the template offset in the offsets' type.
    const W left_d = round_to<D>(add(round_to<D>(W(col)), W(a.tw * 0.5 - 0.5)));
    const W top_d = round_to<D>(add(round_to<D>(W(row)), W(a.th * 0.5 - 0.5)));
    const size_t at = static_cast<size_t>(point) * 2;
    X left, top;
    if (a.duv_wide) {
      const X* duv = static_cast<const X*>(a.duv);
      left = add(X(left_d), duv[at]);
      top = add(X(top_d), duv[at + 1]);
    } else {
      const D* duv = static_cast<const D*>(a.duv);
      left = X(round_to<D>(add(left_d, widen(duv[at]))));
      top = X(round_to<D>(add(top_d, widen(duv[at + 1]))));
    }
    X* cols = static_cast<X*>(a.cols) + static_cast<size_t>(point) * a.p;
    X* rows = static_cast<X*>(a.rows) + static_cast<size_t>(point) * a.p;
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) {
        load(c);
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (c * kChunk + k * kThreads + t < a.p) project(cam, x[k], y[k], z[k], u[k], v[k]);
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = c * kChunk + k * kThreads + t;
        if (i < a.p) {
          cols[i] = sub(sub(u[k], left), X(0.5));
          rows[i] = sub(sub(v[k], top), X(0.5));
        }
      }
    }
  }
}

template <typename D>
int launch(const Args& a, cudaStream_t stream) {
  project_extract_kernel<D><<<static_cast<unsigned>(a.n), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The front end of o observers for n points of p particles: particles
// (n, p, stride), weights (n, p) and their totals over p (n,) of type `dtype`,
// cameras (o, 20) of float32, template offsets (o, n, 2) of the particles'
// type or, with duv_wide, of the computing type, images (o, h, w) of
// `image_bytes` an element (2, 4 or 8). Writes tiles (o n, sh, sw) and cols
// and rows (o n, p) of the computing type: float64 for float64 particles,
// else float32. corrections holds 3 o doubles: for each
// observer whether it has an elevation correction, (refraction - 1) and
// 1 / (2 radius), rounded to the computing type.
extern "C" int glimpse_project_extract(const void* particles, const void* weights, const void* totals,
                                       const void* cams, const void* duv, const void* images, void* tiles,
                                       void* cols, void* rows, long long n, int o, int p, int stride, int h,
                                       int w, int th, int tw, int sh, int sw, int dtype, int image_bytes,
                                       int duv_wide, const double* corrections, void* stream) {
  if (n == 0 || o == 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || n > 0x7fffffffLL || o < 0 || o > kMaxObservers || p < 0 || stride < 3 || sh < 1 || sw < 1 ||
      h < sh || w < sw || (image_bytes != 2 && image_bytes != 4 && image_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{particles, weights, totals, cams, duv, images, tiles, cols, rows, n, o, p, stride, h, w, th, tw, sh, sw,
         image_bytes, duv_wide, {}};
  for (int i = 0; i < o; ++i) {
    a.corrections.on[i] = corrections[3 * i] != 0.0;
    a.corrections.scale[i] = corrections[3 * i + 1];
    a.corrections.inverse[i] = corrections[3 * i + 2];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(a, s);
    case kFloat64: return launch<double>(a, s);
    case kFloat16: return launch<__half>(a, s);
    case kBFloat16: return launch<__nv_bfloat16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
