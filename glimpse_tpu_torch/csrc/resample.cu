// Systematic resampling of particles and weights by a threshold table.
//
// Replaces the TPU kernel glimpse_tpu/kernels/resample_pallas.py
// (systematic_resample_gather, all four layouts: _kernel_mxu_shared,
// _kernel_mxu_rows, _kernel_direct and _kernel). For each point n and output
// slot j:
//   src = min(#{i : t[n, i] < j}, P - 1)
//   out_particles[n, j, :] = particles[n, src, :]   (6 elements)
//   out_weights[n, j]      = weights[n, src]
// with t = P * cumsum(w / sum(w)) - u non-decreasing, so the count is a lower
// bound: the bisection below is torch.searchsorted(side='left') on one row,
// and a NaN threshold counts as below every j, as `!(t >= j)` reads it.
//
// The payload (particles and weights) may be float32, float64, float16 or
// bfloat16; the thresholds are float32 in every case, as the TPU kernel's
// are (a 16-bit table could not count 2,048 particles). The copies move the
// payload's bits, so the kernel is a template on the element's size alone:
// 2, 4 or 8 bytes, one entry with the size as an argument.
//
// What bounds it on the card: bytes. It reads the threshold row and the
// selected 7-element source rows and writes 7 elements per output: 4 + 14 E
// bytes a particle for E-byte elements (60 in float32, 32 in 16 bits, 116 in
// float64); the bisection is log2(P) shared-memory reads per output.
//
// The simple design: one block per point. The block stages its threshold row
// in dynamic shared memory (P * 4 bytes; the wrapper refuses rows above the
// 227 KB a block may use), then each thread bisects for its outputs and
// copies the rows. Exact copies: no arithmetic touches the payload. Every
// point has its own block, so no point is left unwritten whatever N is.
// Later work: merge-path in place of bisection, vectorised row copies,
// several points per block.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void systematic_resample_kernel(const float* __restrict__ t,
                                           const T* __restrict__ particles,
                                           const T* __restrict__ weights,
                                           T* __restrict__ out_particles,
                                           T* __restrict__ out_weights,
                                           int P) {
  extern __shared__ float row[];
  const size_t base = static_cast<size_t>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) row[i] = t[base + i];
  __syncthreads();

  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    const float value = static_cast<float>(j);
    int start = 0;
    int end = P;
    while (start < end) {
      const int mid = start + ((end - start) >> 1);
      if (!(row[mid] >= value)) {
        start = mid + 1;
      } else {
        end = mid;
      }
    }
    const size_t src = base + (start < P - 1 ? start : P - 1);
    const size_t dst = base + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) out_particles[dst * 6 + k] = particles[src * 6 + k];
    out_weights[dst] = weights[src];
  }
}

template <typename T>
int launch(const float* t, const void* particles, const void* weights, void* out_particles,
           void* out_weights, int n, int p, cudaStream_t stream) {
  const int smem = p * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        systematic_resample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  systematic_resample_kernel<T><<<n, 256, smem, stream>>>(
      t, static_cast<const T*>(particles), static_cast<const T*>(weights),
      static_cast<T*>(out_particles), static_cast<T*>(out_weights), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Resample N points of P particles whose payload elements are `elem_bytes`
// (2, 4 or 8) bytes each.
extern "C" int glimpse_systematic_resample(const float* t, const void* particles,
                                           const void* weights, void* out_particles,
                                           void* out_weights, int n, int p,
                                           int elem_bytes, void* stream) {
  if (n == 0 || p == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch<unsigned short>(t, particles, weights, out_particles, out_weights, n, p, s);
    case 4: return launch<unsigned int>(t, particles, weights, out_particles, out_weights, n, p, s);
    case 8: return launch<unsigned long long>(t, particles, weights, out_particles, out_weights, n, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
