// The motion's DEM prior of every particle in one launch: read the DEM and its
// sigma raster bilinearly at the particle's (x, y) and write
// (dem - z)^2 / (2 sigma sigma), or 0 where sigma <= 0 (Welty 2018's 3-D
// model). track/batch.py:BatchMotion.log_likelihoods calls it once a step
// through kernels/prior.py:dem_prior, where the motion is informative
// (cartesian or cylindrical, with a DEM sigma).
//
// Replaces no Pallas kernel: the reference computes the prior by XLA ops
// (glimpse_tpu/track/batch.py, BatchMotion.log_likelihoods). The plain
// version is kernels/prior.py:dem_prior_plain, two DeviceRaster.sample calls
// (ops/sampling.py:bilinear_sample: floors, clamps, int64 index planes, four
// gathers and three lerps each) and the prior's where, square and division,
// some 55 launches over (N, P) planes. This kernel computes what that code
// computes on the card, bit for bit:
// - x, y and z in the type X the particles' type D and the rasters' float32
//   grid scalars promote to (float64 for float64 particles, else float32:
//   16-bit particles widen to float32, as _widened makes them);
// - cols = (x - x0) / dx - 0.5 and rows alike, a true division; r0f =
//   clamp(floor(rows), 0, max(h - 2, 0)), r1 = min(r0 + 1, h - 1), fr =
//   rows - r0f, and the same for the columns. A NaN coordinate, which the
//   plain version cannot index (.long() of NaN is the most negative int64,
//   out of the raster), reads cell 0, and its NaN fraction makes the sample
//   NaN;
// - top = v00 + (v01 - v00) fc, bot likewise, then top + (bot - top) fr, the
//   differences of the float32 cells in float32 and the rest in X, so a NaN
//   cell reaches only the samples whose four-cell stencil holds it;
// - a 1 x 1 raster gives its one value, in float32, as sample's expand does
//   (its grid never reaches the lerp): with float64 particles a 1 x 1
//   sigma's denominator is then computed in float32 and widened;
// - safe = sigma > 0 ? sigma : 1, ll = ((dem - z) (dem - z)) / ((2 safe)
//   safe) (the scalar-2 pow is a product), and sigma > 0 ? ll : 0.
// Every product, sum and quotient is an explicit _rn intrinsic, which nvcc
// never contracts into an FMA.
//
// What bounds it on the card: bytes. A particle's x, y and z come in (12 B in
// float32; the records' unread velocities share their 32-byte sectors, so
// the card reads all 24) and its prior goes out (4 B); the two rasters (3.3
// MB at 640 x 640) stay in L2. At oblique-3d's 10,240 points of 2,048
// particles that is 338.8 MB counted once each, 0.101 ms at 3.35 TB/s, or
// about 0.175 ms with the whole records. The arithmetic is some 150
// instructions a particle (five IEEE divisions among them: no reciprocal,
// as the plain version rounds), about 0.1 ms at the card's issue rate. The
// design:
// - one thread a particle over the flat (N P) range, in blocks of 256: a warp
//   reads 32 consecutive records, 768 contiguous bytes, and writes its 32
//   priors coalesced;
// - the eight raster cells a particle reads go through the read-only cache
//   (__ldg): one point's particles sit within a few cells, so they hit L1
//   and L2, and nothing is staged in shared memory (3.3 MB would not fit);
// - where the two rasters share their grid (the same shape and the same
//   scalars, bit for bit), the sigma is read at the DEM's stencil: the same
//   operations on the same values, half the divisions.
// No allocation here: the wrapper allocates the output.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The element types, by the code the wrapper passes (kernels/_build.py:
// DTYPE_CODES), as csrc/project.cu numbers them.
enum Dtype { kFloat32 = 0, kFloat64 = 1, kFloat16 = 2, kBFloat16 = 3 };

// The type the particles meet the float32 grid scalars in: float for the
// 16-bit types and float32, double for float64.
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

__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return ::floor(x); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }

// torch.clamp(x, lo, hi) of a floating tensor on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double clamp_nan(double x, double lo, double hi) {
  return isnan(x) ? x : fmin(fmax(x, lo), hi);
}

// Tensor.long() of a clamped index, and 0 for NaN, whose sample is NaN.
template <typename X>
__device__ __forceinline__ long long index_of(X x) {
  return isnan(x) ? 0LL : static_cast<long long>(x);
}

// One raster: its (h, w) float32 values and its grid's 0-d float32 scalars
// (world x of the left outer edge, y of the top one, signed cell sizes).
struct Raster {
  const float* values;
  const float* x0;
  const float* y0;
  const float* dx;
  const float* dy;
  int h, w;
};

__device__ __forceinline__ bool single(const Raster& r) { return r.h == 1 && r.w == 1; }

// Whether two rasters share their grid: the same shape and the same scalars,
// bit for bit, so that both give the same stencil at every point.
__device__ __forceinline__ bool same_grid(const Raster& a, const Raster& b) {
  return a.h == b.h && a.w == b.w && __float_as_int(__ldg(a.x0)) == __float_as_int(__ldg(b.x0)) &&
         __float_as_int(__ldg(a.y0)) == __float_as_int(__ldg(b.y0)) &&
         __float_as_int(__ldg(a.dx)) == __float_as_int(__ldg(b.dx)) &&
         __float_as_int(__ldg(a.dy)) == __float_as_int(__ldg(b.dy));
}

// bilinear_sample's four cells (flat indices) and fractions at world (x, y).
template <typename X>
struct Stencil {
  long long i00, i01, i10, i11;
  X fr, fc;
};

template <typename X>
__device__ __forceinline__ Stencil<X> stencil(const Raster& r, X x, X y) {
  const X cols = sub(quot(sub(x, X(__ldg(r.x0))), X(__ldg(r.dx))), X(0.5));
  const X rows = sub(quot(sub(y, X(__ldg(r.y0))), X(__ldg(r.dy))), X(0.5));
  const X r0f = clamp_nan(floor_of(rows), X(0), X(max(r.h - 2, 0)));
  const X c0f = clamp_nan(floor_of(cols), X(0), X(max(r.w - 2, 0)));
  const long long r0 = index_of(r0f);
  const long long c0 = index_of(c0f);
  const long long r1 = min(r0 + 1, static_cast<long long>(r.h - 1));
  const long long c1 = min(c0 + 1, static_cast<long long>(r.w - 1));
  Stencil<X> s;
  s.i00 = r0 * r.w + c0;
  s.i01 = r0 * r.w + c1;
  s.i10 = r1 * r.w + c0;
  s.i11 = r1 * r.w + c1;
  s.fr = sub(rows, r0f);
  s.fc = sub(cols, c0f);
  return s;
}

template <typename X>
__device__ __forceinline__ X lerp(const Raster& r, const Stencil<X>& s) {
  const float v00 = __ldg(r.values + s.i00);
  const float v01 = __ldg(r.values + s.i01);
  const float v10 = __ldg(r.values + s.i10);
  const float v11 = __ldg(r.values + s.i11);
  const X top = add(X(v00), mul(X(__fsub_rn(v01, v00)), s.fc));
  const X bot = add(X(v10), mul(X(__fsub_rn(v11, v10)), s.fc));
  return add(top, mul(sub(bot, top), s.fr));
}

struct Args {
  const void* particles;  // (n, stride) of D: x, y, z first
  void* out;              // (n,) of X
  Raster dem, sigma;
  long long n;
  int stride;
};

template <typename D>
__global__ void __launch_bounds__(kThreads) dem_prior_kernel(const Args a) {
  using X = typename Compute<D>::type;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const D* p = static_cast<const D*>(a.particles) + i * a.stride;
  const X x = X(widen(p[0]));
  const X y = X(widen(p[1]));
  const X z = X(widen(p[2]));
  const bool dem_single = single(a.dem);
  Stencil<X> at;
  if (!dem_single) at = stencil(a.dem, x, y);
  const X dem = dem_single ? X(__ldg(a.dem.values)) : lerp(a.dem, at);
  X sigma, denominator;
  if (single(a.sigma)) {
    // sample's float32 value: its safe value and (2 safe) safe in float32.
    const float s = __ldg(a.sigma.values);
    const float safe = s > 0.0f ? s : 1.0f;
    sigma = X(s);
    denominator = X(__fmul_rn(__fmul_rn(2.0f, safe), safe));
  } else {
    if (dem_single || !same_grid(a.dem, a.sigma)) at = stencil(a.sigma, x, y);
    sigma = lerp(a.sigma, at);
    const X safe = sigma > X(0) ? sigma : X(1);
    denominator = mul(mul(X(2), safe), safe);
  }
  const X gap = sub(dem, z);
  const X ll = quot(mul(gap, gap), denominator);
  static_cast<X*>(a.out)[i] = sigma > X(0) ? ll : X(0);
}

template <typename D>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dem_prior_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The DEM prior of n particles (n, stride) of type `dtype` (x, y and z their
// first three values) against the DEM (dem_h, dem_w) and its sigma raster
// (sigma_h, sigma_w), both float32, each with its grid's four 0-d float32
// scalars on the card. Writes out (n,) in float64 for float64 particles,
// else in float32.
extern "C" int glimpse_dem_prior(const void* particles, void* out, const void* dem, const void* dem_x0,
                                 const void* dem_y0, const void* dem_dx, const void* dem_dy, const void* sigma,
                                 const void* sigma_x0, const void* sigma_y0, const void* sigma_dx,
                                 const void* sigma_dy, long long n, int stride, int dem_h, int dem_w, int sigma_h,
                                 int sigma_w, int dtype, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || stride < 3 || dem_h < 1 || dem_w < 1 || sigma_h < 1 || sigma_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto as_float = [](const void* v) { return static_cast<const float*>(v); };
  const Args a{particles,
               out,
               {as_float(dem), as_float(dem_x0), as_float(dem_y0), as_float(dem_dx), as_float(dem_dy), dem_h, dem_w},
               {as_float(sigma), as_float(sigma_x0), as_float(sigma_y0), as_float(sigma_dx), as_float(sigma_dy),
                sigma_h, sigma_w},
               n,
               stride};
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
