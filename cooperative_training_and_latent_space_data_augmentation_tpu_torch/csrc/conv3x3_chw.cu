// K1: SAME stride-1 3x3 convolution in the CHW layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv.py:conv3x3_chw (its pallas_call; _conv_kernel and _build_p).
// That kernel builds the tap-stacked matrix P (9*C_in, H*W) of one image in
// VMEM and runs one MXU matmul W_all (C_out, 9*C_in) @ P per image.  This
// kernel computes the same function,
//
//   out[n, o, y*W + x] = sum_{ki, kj, i} w_all[o, (3*ki + kj)*C_in + i]
//                                        * x[n, i, (y+ki-1)*W + (x+kj-1)],
//
// with out-of-image taps reading zero, f32 accumulation and one rounding to
// the input type at the store.
//
// What bounds it on the H100: at the main path's shapes (C_in <= 64,
// C_out <= 64, 24^2..192^2 pixels) the bytes to move (input read once,
// output written once) take longer at 3.35 TB/s than the MACs take on the
// tensor cores, so the ideal kernel is memory-bound.  This first design runs
// the MACs on the CUDA cores in f32 instead (67 TFLOP/s peak), which makes
// it bound by operations; moving the inner product to mma/wgmma is later
// work.
//
// What the design does about it: P is never written to device memory.  One
// block owns one image and a TH x TW tile of output pixels, one thread per
// pixel, all C_out (<= 64) sums in registers.  It stages a chunk of CK input
// channels of its tile plus a one-pixel halo in shared memory, and the
// matching (CK, 9, C_out) slice of the weights, so each input pixel is read
// from device memory about (TH+2)(TW+2)/(TH*TW) = 1.33 times.  Edge
// masking: the halo is filled from 2-D (row, column) coordinates and is zero
// outside the image, so a tap never wraps from one row into the next (the
// flat-pixel offsets of the TPU kernel would, and it masks columns 0 and
// W-1 per tap for that reason).
//
// C interface (bound with ctypes): conv3x3_chw(...) launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;           // tile width: one warp per tile row
constexpr int TH = 8;            // tile height
constexpr int NT = TW * TH;      // threads per block
constexpr int CK = 8;            // input channels staged per pass
constexpr int SW = TW + 2;       // staged width with halo
constexpr int SH = TH + 2;       // staged height with halo
constexpr int MAX_COUT = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// COB: C_out rounded up to the bucket the sums are kept for (a multiple of
// 4, so the weights are read as float4).  Sums for o >= C_out see zero
// weights and are not stored.
template <typename T, int COB>
__global__ void __launch_bounds__(NT)
conv3x3_chw_kernel(const T* __restrict__ x, const T* __restrict__ w_all,
                   T* __restrict__ out, int c_in, int c_out, int H, int W) {
  __shared__ float s_x[CK][SH][SW];
  __shared__ __align__(16) float s_w[CK][9][COB];

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const long long L = (long long)H * W;
  const T* xn = x + (long long)blockIdx.z * c_in * L;

  float acc[COB];
#pragma unroll
  for (int o = 0; o < COB; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < c_in; c0 += CK) {
    const int ck = min(CK, c_in - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < CK * SH * SW; e += NT) {
      const int ci = e / (SH * SW);
      const int r = (e / SW) % SH;
      const int c = e % SW;
      const int gy = y0 + r - 1;
      const int gx = x0 + c - 1;
      float v = 0.f;
      if (ci < ck && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load_f32(xn + (long long)(c0 + ci) * L + (long long)gy * W + gx);
      s_x[ci][r][c] = v;
    }
    for (int e = tid; e < CK * 9 * COB; e += NT) {
      const int ci = e / (9 * COB);
      const int t = (e / COB) % 9;
      const int o = e % COB;
      float v = 0.f;
      if (ci < ck && o < c_out)
        v = load_f32(w_all + (long long)o * 9 * c_in + t * c_in + c0 + ci);
      s_w[ci][t][o] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < ck; ++ci) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = s_x[ci][ty + t / 3][tx + t % 3];
        const float4* w4 = reinterpret_cast<const float4*>(&s_w[ci][t][0]);
#pragma unroll
        for (int q = 0; q < COB / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = fmaf(w.x, v, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(w.y, v, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(w.z, v, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(w.w, v, acc[4 * q + 3]);
        }
      }
    }
  }

  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (gy < H && gx < W) {
    T* on = out + (long long)blockIdx.z * c_out * L + (long long)gy * W + gx;
#pragma unroll
    for (int o = 0; o < COB; ++o)
      if (o < c_out) store_from_f32(on + (long long)o * L, acc[o]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_all, void* out, int n,
                   int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  const dim3 block(NT);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w_all);
  T* op = static_cast<T*>(out);
  if (c_out <= 16)
    conv3x3_chw_kernel<T, 16><<<grid, block, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else if (c_out <= 32)
    conv3x3_chw_kernel<T, 32><<<grid, block, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else
    conv3x3_chw_kernel<T, 64><<<grid, block, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, c_in, h*w), w_all: (c_out, 9*c_in) tap-major, out: (n, c_out, h*w),
// all contiguous on the current device, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  Returns a cudaError_t as int.
int conv3x3_chw(const void* x, const void* w_all, void* out, int n, int c_in,
                int c_out, int h, int w, int is_bf16, void* stream) {
  if (n < 1 || n > 65535 || c_in < 1 || c_out < 1 || c_out > MAX_COUT ||
      h < 1 || w < 1 || (h + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w_all, out, n, c_in, c_out, h, w, s)
              : launch<float>(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_chw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
