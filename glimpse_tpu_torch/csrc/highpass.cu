// Median high-pass over a stack of tiles: out = tile - median_{kh x kw}(tile).
//
// Replaces the TPU kernel glimpse_tpu/kernels/highpass_pallas.py
// (median_highpass, body _median_hp_kernel). Same function, same domain:
// float32 tiles (N, h, w), odd kh and kw with kh * kw <= 49, symmetric
// padding that includes the edge pixel (row -1 reads row 0, row h reads
// row h - 1), as numpy's mode="symmetric".
//
// What bounds it on the card: bytes. Each tile is read once and written once,
// about 2 * N * h * w * 4 bytes; the selection network is register work
// (300 min/max pairs for 5x5) that hides behind those loads at these sizes.
//
// The simple design: one block per tile. The block stages the padded
// (h + kh - 1) x (w + kw - 1) window in shared memory, computing the
// reflection itself, so every pixel is read from device memory once. Each
// thread then owns one output pixel at a time, pulls its taps from shared
// memory into registers and sorts them with an odd-even transposition
// network. The network is compiled for S = 9, 25 or 49 taps; a window with
// fewer taps is padded with equal numbers of -inf and +inf, which leaves the
// middle element where it was. Selection does no arithmetic, so for finite
// input the result is bit-equal to the sort-based median. Later work: several
// tiles per block, cp.async/TMA staging, a shorter selection network.
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int S>
__device__ __forceinline__ float median_of(float (&v)[S]) {
#pragma unroll
  for (int round = 0; round < S; ++round) {
#pragma unroll
    for (int i = round & 1; i < S - 1; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      const float hi = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
      v[i + 1] = hi;
    }
  }
  return v[S / 2];
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i - 1 : (i >= n ? 2 * n - i - 1 : i);
}

template <int S>
__global__ void median_highpass_kernel(const float* __restrict__ in,
                                       float* __restrict__ out, int h, int w,
                                       int kh, int kw) {
  extern __shared__ float window[];
  const int ph = kh / 2;
  const int pw = kw / 2;
  const int ih = h + kh - 1;
  const int iw = w + kw - 1;
  const size_t base = static_cast<size_t>(blockIdx.x) * h * w;
  const float* tile = in + base;
  for (int k = threadIdx.x; k < ih * iw; k += blockDim.x) {
    const int r = reflect(k / iw - ph, h);
    const int c = reflect(k % iw - pw, w);
    window[k] = tile[r * w + c];
  }
  __syncthreads();

  const int taps = kh * kw;
  const int lo_pad = (S - taps) / 2;
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const int y = p / w;
    const int x = p - y * w;
    float v[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int q = t - lo_pad;
      if (q < 0) {
        v[t] = -INFINITY;
      } else if (q < taps) {
        const int dy = q / kw;
        const int dx = q - dy * kw;
        v[t] = window[(y + dy) * iw + x + dx];
      } else {
        v[t] = INFINITY;
      }
    }
    const float med = median_of<S>(v);
    out[base + p] = window[(y + ph) * iw + x + pw] - med;
  }
}

template <int S>
cudaError_t launch(const float* in, float* out, int n, int h, int w, int kh,
                   int kw, cudaStream_t stream) {
  const int smem = (h + kh - 1) * (w + kw - 1) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        median_highpass_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  median_highpass_kernel<S><<<n, 256, smem, stream>>>(in, out, h, w, kh, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int glimpse_median_highpass(const float* in, float* out, int n,
                                       int h, int w, int kh, int kw,
                                       void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int taps = kh * kw;
  if (taps <= 9) return static_cast<int>(launch<9>(in, out, n, h, w, kh, kw, s));
  if (taps <= 25) return static_cast<int>(launch<25>(in, out, n, h, w, kh, kw, s));
  return static_cast<int>(launch<49>(in, out, n, h, w, kh, kw, s));
}

extern "C" const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
