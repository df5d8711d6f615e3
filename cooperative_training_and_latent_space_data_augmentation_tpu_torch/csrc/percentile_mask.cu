// K3: the percentile-threshold mask of targeted latent masking, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_kernels.py:fused_percentile_mask (its pallas_call; _mask_kernel).
// For each row of an (N, D) saliency s it computes
//
//   idx     = clip(floor(f32(D) * p), 0, D - 1)
//   rank_e  = #{j < D : s_j >= s_e}
//   mask_e  = rank_e <= idx ? soft_e : 1
//
// which masks exactly the elements strictly greater than the value at index
// idx of the row sorted in descending order (the reference's
// sort(desc)[:, int(D * p)] threshold).  An element equal to the threshold
// value has a rank above idx and stays unmasked.
//
// What bounds it on the H100: nothing much.  At N = 20 rows of D = 128 or
// 144 it reads and writes about 35 KB and does N * D * D = 0.4 M compares;
// a launch costs more than either.  The TPU kernel's (N, D, D) compare
// block becomes one block per row: the row is staged in shared memory, one
// thread per element counts its rank over the staged row (broadcast reads),
// so D need not be a multiple of 32 and no padding lane enters a count.
// p stays on the device: the kernel computes idx itself, in f32 as JAX does
// (pallas_kernels.py:65), so the caller needs no host sync.
//
// C interface (bound with ctypes): percentile_mask(...) launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_D = 4096;

__global__ void percentile_mask_kernel(const float* __restrict__ sal,
                                       const float* __restrict__ p,
                                       const float* __restrict__ soft,
                                       float* __restrict__ out, int d) {
  __shared__ float s_row[MAX_D];
  const long long base = (long long)blockIdx.x * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) s_row[e] = sal[base + e];
  __syncthreads();
  // floor in f32, clipped to [0, D-1] before the conversion (a NaN p gives 0)
  const float f = floorf(static_cast<float>(d) * p[0]);
  const int idx = static_cast<int>(fminf(fmaxf(f, 0.f), static_cast<float>(d - 1)));
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    const float v = s_row[e];
    int rank = 0;
    for (int j = 0; j < d; ++j) rank += s_row[j] >= v;
    out[base + e] = rank <= idx ? soft[base + e] : 1.f;
  }
}

}  // namespace

extern "C" {

// sal, soft, out: (n, d) float32, contiguous; p: one float32; all on the
// current device.  Returns a cudaError_t as int.
int percentile_mask(const void* sal, const void* p, const void* soft, void* out,
                    int n, int d, void* stream) {
  if (n < 1 || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = d >= 1024 ? 1024 : ((d + 31) / 32) * 32;
  percentile_mask_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sal), static_cast<const float*>(p),
      static_cast<const float*>(soft), static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

const char* percentile_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
