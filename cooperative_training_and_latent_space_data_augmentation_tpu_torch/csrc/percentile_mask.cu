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
// What bounds it on the H100: latency.  At N = 20 rows of D = 128 or 144 it
// reads and writes about 35 KB and does N * D * D = 0.4 M compares; one
// launch with one trip to device memory costs more than either.  So the
// design keeps the critical path short:
//
// * Every load comes first.  A thread loads its element's saliency and soft
//   value, p, and its share of the row (staged in shared memory, NaN-padded
//   to a multiple of 32) before the one barrier and before any compare:
//   one round trip to device memory, soft is never waited on after the
//   count.
// * The D * D compares of a row are spread over a grid of (N, ceil(D / 32))
//   blocks of 256 threads (at N = 20: 80 blocks at D = 128, 100 at 144).  A
//   block owns 32 elements of a row; LANES = 8 threads share an element,
//   each counting its rank over every 32nd group of 4 row entries (one
//   16-byte shared load, 4 independent counters), and the 8 lane counts
//   meet by 3 shuffles.  A warp's shared load reads 128 contiguous bytes,
//   the same for its 4 elements: no bank conflict.
// * Padding never enters a count: the row's padding entries are NaN, and
//   NaN >= v is false.  An element past D is loaded clamped and not stored.
//
// One route for every 1 <= D <= MAX_D.  p stays on the device: the kernel
// computes idx itself, in f32 as JAX does (pallas_kernels.py:65), so the
// caller needs no host sync.
//
// C interface (bound with ctypes): percentile_mask(...) launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_D = 4096;
constexpr int LANES = 8;                // threads that share one element's count
constexpr int ELEMS = 32;               // elements of a row a block owns
constexpr int THREADS = LANES * ELEMS;  // 256
constexpr int PAD = 4 * LANES;          // the staged row's length is a multiple of this

__global__ void __launch_bounds__(THREADS)
percentile_mask_kernel(const float* __restrict__ sal, const float* __restrict__ p,
                       const float* __restrict__ soft, float* __restrict__ out, int d) {
  extern __shared__ float4 s_row4[];  // the row, NaN-padded to dpad entries
  float* s_row = reinterpret_cast<float*>(s_row4);
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const int t = threadIdx.x;
  const int k = t % LANES;
  const int e = blockIdx.y * ELEMS + t / LANES;
  const int ec = min(e, d - 1);
  const int dpad = (d + PAD - 1) / PAD * PAD;
  // every load before the barrier and the compares
  const float v = sal[base + ec];
  const float sv = soft[base + ec];
  const float pv = p[0];
#pragma unroll 4
  for (int j = t; j < dpad; j += THREADS)
    s_row[j] = j < d ? sal[base + j] : __int_as_float(0x7fffffff);
  __syncthreads();
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
  for (int j = k; j < dpad / 4; j += LANES) {
    const float4 q = s_row4[j];
    c0 += q.x >= v;
    c1 += q.y >= v;
    c2 += q.z >= v;
    c3 += q.w >= v;
  }
  int rank = (c0 + c1) + (c2 + c3);
  // the LANES threads of an element are consecutive lanes of one warp
  rank += __shfl_xor_sync(0xffffffffu, rank, 4);
  rank += __shfl_xor_sync(0xffffffffu, rank, 2);
  rank += __shfl_xor_sync(0xffffffffu, rank, 1);
  // floor in f32, clipped to [0, D-1] before the conversion (a NaN p gives 0)
  const float f = floorf(static_cast<float>(d) * pv);
  const int idx = static_cast<int>(fminf(fmaxf(f, 0.f), static_cast<float>(d - 1)));
  if (k == 0 && e < d) out[base + e] = rank <= idx ? sv : 1.f;
}

}  // namespace

extern "C" {

// sal, soft, out: (n, d) float32, contiguous; p: one float32; all on the
// current device.  Returns a cudaError_t as int.
int percentile_mask(const void* sal, const void* p, const void* soft, void* out,
                    int n, int d, void* stream) {
  if (n < 1 || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n, (d + ELEMS - 1) / ELEMS);
  const size_t smem = static_cast<size_t>((d + PAD - 1) / PAD * PAD) * sizeof(float);
  percentile_mask_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sal), static_cast<const float*>(p),
      static_cast<const float*>(soft), static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

const char* percentile_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
