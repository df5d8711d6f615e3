// K5 and K5dw: the SAME stride-1 3x3 convolution for large channel counts
// (64..256 on either side) and its weight gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv.py:conv3x3_nl (its pallas_call; _conv_nl_kernel and
// _build_p_nl) and _conv3x3_nl_dw (_dw_nl_kernel).  Those run channels-last:
// per chunk of images they build the tap matrix P (M, 9*C_in) from rolled,
// edge-masked copies of the flattened (M, C_in) activations in VMEM and run
// P @ W_all on the MXU (forward), or accumulate P^T @ dY over a sequential
// grid of chunks (dw).  These kernels compute the same functions on the
// port's NCHW layout, x (N, C_in, H*W):
//
//   out[n, o, p]          = sum_{t, i} w_all[o, t*C_in + i] * P[(n, p), t*C_in + i]
//   dw[t*C_in + i, o]     = sum_{n, p} P[(n, p), t*C_in + i] * dy[n, o, p]
//   P[(n, p), t*C_in + i] = x[n, i, p + (ki-1)*W + (kj-1)] where the tap stays
//                           in the image, else 0 (t = 3*ki + kj)
//
// with f32 accumulation; the forward rounds once to the input type at the
// store, dw is returned in f32.
//
// What bounds them on the H100: at the main path's shapes (64->128, 128->128
// and 128->64 at 24^2 and 12^2, batch 20) the MACs dominate the bytes, so on
// paper both are bound by operations: 0.9-3.4 us on the tensor cores in bf16.
// On the CUDA cores the same work cannot take less than about 51 us at
// 128->128 on 24^2 (67 TFLOP/s of f32).  So the bf16 path runs its products
// on the tensor cores (mma.sync.aligned.m16n8k16, bf16 inputs, f32
// accumulators); the f32 path stays on f32 FMAs in full precision (no TF32:
// the port's f32 convs are full f32).
//
// What the design does about it: both are implicit GEMMs.  P is never written
// to device memory.  A block owns a 64 x 64 tile of the result and 4 warps,
// each 32 x 32 of it (2 x 4 tiles of 16 x 8, 32 accumulators a thread, in
// the mma accumulator layout in both paths).  The reduction runs in steps of
// 32: each step stages a 64 x 32 tile of P (gathered from x with the tap's
// shift and the image-edge masks, as the TPU kernel's roll and mask do) and
// a 64 x 32 tile of the other operand in shared memory, both with the
// reduction index contiguous and rows padded to avoid bank conflicts on the
// fragment loads.
//
//   * K5: rows are pixels (M = N*H*W, batch-major), columns output channels;
//     the reduction walks the 9 taps and, in each, the input channels in
//     steps of 32.  The other operand is the wall, read as (C_out, 9*C_in).
//   * K5dw: rows are the 9*C_in wall rows, columns output channels; the
//     reduction walks pixels.  Hopper's blocks run in no order, so the TPU
//     kernel's accumulation across its grid becomes two passes with a fixed
//     summation order and no float atomics: pixels are cut into slabs (their
//     number depends on the shapes only), each block writes the partial sum
//     of its slab to a workspace slot of its own, and a second kernel adds
//     the slots in slot order.  Two launches agree bit for bit.
//
// C interface (bound with ctypes): conv3x3_nl(...) and conv3x3_nl_dw(...)
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError() of the launches (0 on success);
// conv3x3_nl_dw_workspace(...) gives the workspace size in floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of a block's tile
constexpr int BN = 64;   // columns of a block's tile
constexpr int KK = 32;   // reduction depth of one staged step
constexpr int NT = 128;  // threads: 4 warps, 2 x 2 over the tile
constexpr long long TARGET_BLOCKS = 528;  // K5dw: about four blocks per SM

// Staged rows: the reduction index contiguous, padded so that the 8 rows a
// fragment load touches fall in distinct banks.
template <typename T> struct Stage;
template <> struct Stage<float> { static constexpr int RS = KK + 4; };
template <> struct Stage<__nv_bfloat16> { static constexpr int RS = KK + 8; };

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One staged step of this warp's 32 x 32 part: acc += A . B^T with A the
// (BM, KK) tile As[r * RS + k] and B the (BN, KK) tile Bs[c * RS + k].
// acc[mi][ni][e]: rows wr + 16*mi + g (+8 for e >= 2), columns
// wc + 8*ni + 2*q + (e & 1), with g = lane / 4, q = lane % 4 (the
// m16n8 accumulator layout).
__device__ __forceinline__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                     float (&acc)[2][4][4], int wr, int wc, int lane) {
  constexpr int RS = Stage<__nv_bfloat16>::RS;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KK; k0 += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = As + (wr + 16 * mi + g) * RS + k0 + 2 * q;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = Bs + (wc + 8 * ni + g) * RS + k0 + 2 * q;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void step(const float* As, const float* Bs,
                                     float (&acc)[2][4][4], int wr, int wc, int lane) {
  constexpr int RS = Stage<float>::RS;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = As[(wr + 16 * mi + g) * RS + k];
      a[mi][1] = As[(wr + 16 * mi + g + 8) * RS + k];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      b[ni][0] = Bs[(wc + 8 * ni + 2 * q) * RS + k];
      b[ni][1] = Bs[(wc + 8 * ni + 2 * q + 1) * RS + k];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float* d = acc[mi][ni];
        d[0] = fmaf(a[mi][0], b[ni][0], d[0]);
        d[1] = fmaf(a[mi][0], b[ni][1], d[1]);
        d[2] = fmaf(a[mi][1], b[ni][0], d[2]);
        d[3] = fmaf(a[mi][1], b[ni][1], d[3]);
      }
  }
}

// K5.  Grid (ceil(M / BM), ceil(C_out / BN)).  Thread tid stages pixel row
// tid % BM of the P tile, input channels tid / BM + 2*s of the step.
template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_nl_kernel(const T* __restrict__ x, const T* __restrict__ w_all,
                  T* __restrict__ out, int n_img, int c_in, int c_out, int H, int W) {
  constexpr int RS = Stage<T>::RS;
  __shared__ __align__(16) T As[BM * RS];
  __shared__ __align__(16) T Bs[BN * RS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const int L = H * W;
  const long long M = (long long)n_img * L;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const T zero = zero_of(T());

  const int ar = tid % BM, aj = tid / BM;
  const long long m = m0 + ar;
  int img = 0, py = 0, px = 0;
  if (m < M) {
    img = (int)(m / L);
    const int p = (int)(m - (long long)img * L);
    py = p / W;
    px = p - py * W;
  }
  const T* xn = x + (long long)img * c_in * L;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int t = 0; t < 9; ++t) {
    const int sy = py + t / 3 - 1, sx = px + t % 3 - 1;
    const bool valid = m < M && sy >= 0 && sy < H && sx >= 0 && sx < W;
    const T* xs = xn + sy * W + sx;
    for (int c0 = 0; c0 < c_in; c0 += KK) {
      __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll 4
      for (int s = 0; s < KK / 2; ++s) {
        const int j = aj + 2 * s;
        As[ar * RS + j] = (valid && c0 + j < c_in) ? xs[(long long)(c0 + j) * L] : zero;
      }
      for (int e = tid; e < BN * KK; e += NT) {
        const int o = e / KK, j = e % KK;
        T v = zero;
        if (o0 + o < c_out && c0 + j < c_in)
          v = w_all[(long long)(o0 + o) * 9 * c_in + t * c_in + c0 + j];
        Bs[o * RS + j] = v;
      }
      __syncthreads();
      step(As, Bs, acc, wr, wc, lane);
    }
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long mm = m0 + wr + 16 * mi + g + 8 * h;
      if (mm >= M) continue;
      const int n = (int)(mm / L);
      const int p = (int)(mm - (long long)n * L);
      T* on = out + (long long)n * c_out * L + p;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wc + 8 * ni + 2 * q + e;
          if (o < c_out) store_from_f32(on + (long long)o * L, acc[mi][ni][2 * h + e]);
        }
    }
}

// K5dw, pass 1.  Grid (ceil(9*C_in / BM), ceil(C_out / BN), slabs): the
// block's (BM, BN) tile of dw summed over the pixels [slab * z, min(M,
// slab * (z+1))), written to workspace slot z.  Thread tid stages pixel
// tid % KK of the step for wall rows (or output channels) tid / KK + 4*s.
template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_nl_dw_partial(const T* __restrict__ x, const T* __restrict__ dy,
                      float* __restrict__ ws, int n_img, int c_in, int c_out, int H,
                      int W, long long slab) {
  constexpr int RS = Stage<T>::RS;
  __shared__ __align__(16) T As[BM * RS];
  __shared__ __align__(16) T Bs[BN * RS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const int L = H * W;
  const int K = 9 * c_in;
  const long long M = (long long)n_img * L;
  const int k0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const long long s0 = slab * blockIdx.z;
  const long long s1 = min(M, s0 + slab);
  const T zero = zero_of(T());
  const int pm = tid % KK, pr = tid / KK;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (long long base = s0; base < s1; base += KK) {
    const long long m = base + pm;
    const bool in_m = m < s1;
    int img = 0, p = 0, py = 0, px = 0;
    if (in_m) {
      img = (int)(m / L);
      p = (int)(m - (long long)img * L);
      py = p / W;
      px = p - py * W;
    }
    const T* xn = x + (long long)img * c_in * L;
    const T* dn = dy + (long long)img * c_out * L + p;
    __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll 4
    for (int s = 0; s < BM / 4; ++s) {
      const int r = pr + 4 * s;
      const int k = k0 + r;
      T v = zero;
      if (in_m && k < K) {
        const int t = k / c_in;
        const int i = k - t * c_in;
        const int sy = py + t / 3 - 1, sx = px + t % 3 - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) v = xn[(long long)i * L + sy * W + sx];
      }
      As[r * RS + pm] = v;
    }
#pragma unroll 4
    for (int s = 0; s < BN / 4; ++s) {
      const int o = pr + 4 * s;
      Bs[o * RS + pm] = (in_m && o0 + o < c_out) ? dn[(long long)(o0 + o) * L] : zero;
    }
    __syncthreads();
    step(As, Bs, acc, wr, wc, lane);
  }

  float* wp = ws + (long long)blockIdx.z * K * c_out;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wr + 16 * mi + g + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wc + 8 * ni + 2 * q + e;
          if (o < c_out) wp[(long long)k * c_out + o] = acc[mi][ni][2 * h + e];
        }
    }
}

// K5dw, pass 2: out[e] = sum over slots z = 0 .. parts-1 of ws[z][e], in
// slot order.
__global__ void conv3x3_nl_dw_reduce(const float* __restrict__ ws,
                                     float* __restrict__ out, int parts, long long k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  float s = 0.f;
  for (int z = 0; z < parts; ++z) s += ws[(long long)z * k + e];
  out[e] = s;
}

// How K5dw cuts the pixels: slabs of `slab` pixels (a multiple of KK),
// `parts` of them, about TARGET_BLOCKS blocks in all.  Shapes only.
struct Slabs {
  long long slab;
  int parts;
};

Slabs slabs(int n, int c_in, int c_out, int h, int w) {
  const long long M = (long long)n * h * w;
  const long long tiles = (long long)((9 * c_in + BM - 1) / BM) * ((c_out + BN - 1) / BN);
  long long want = TARGET_BLOCKS / tiles;
  if (want < 1) want = 1;
  long long slab = (M + want - 1) / want;
  slab = (slab + KK - 1) / KK * KK;
  Slabs s;
  s.slab = slab;
  s.parts = (int)((M + slab - 1) / slab);
  return s;
}

bool valid(int n, int c_in, int c_out, int h, int w) {
  if (n < 1 || c_in < 1 || c_out < 1 || h < 1 || w < 1) return false;
  const long long M = (long long)n * h * w;
  return M <= (1LL << 40) && (M + BM - 1) / BM <= 0x7fffffffLL &&
         (c_out + BN - 1) / BN <= 65535 && (long long)h * w <= 0x7fffffffLL &&
         (long long)c_in * h * w <= 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w_all, void* out, int n, int c_in,
                       int c_out, int h, int w, cudaStream_t stream) {
  const long long M = (long long)n * h * w;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (c_out + BN - 1) / BN);
  conv3x3_nl_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_all), static_cast<T*>(out), n, c_in,
      c_out, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, float* ws, float* out, int n, int c_in,
                      int c_out, int h, int w, cudaStream_t stream) {
  const Slabs s = slabs(n, c_in, c_out, h, w);
  const dim3 grid((9 * c_in + BM - 1) / BM, (c_out + BN - 1) / BN, s.parts);
  conv3x3_nl_dw_partial<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, n, c_in, c_out, h, w, s.slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long k = 9LL * c_in * c_out;
  const int threads = 256;
  conv3x3_nl_dw_reduce<<<(unsigned)((k + threads - 1) / threads), threads, 0, stream>>>(
      ws, out, s.parts, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, c_in, h*w), w_all: (c_out, 9*c_in) tap-major, out: (n, c_out, h*w),
// all contiguous on the current device, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  Returns a cudaError_t as int.
int conv3x3_nl(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
               int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(x, w_all, out, n, c_in, c_out, h, w, s)
              : launch_fwd<float>(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3_nl_dw needs for these shapes (0 if invalid).
long long conv3x3_nl_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  return (long long)slabs(n, c_in, c_out, h, w).parts * 9 * c_in * c_out;
}

// x: (n, c_in, h*w), dy: (n, c_out, h*w), both contiguous on the current
// device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); ws: at least
// conv3x3_nl_dw_workspace(...) floats; out: (9*c_in, c_out) float32, row
// t*c_in + i.  Returns a cudaError_t as int.
int conv3x3_nl_dw(const void* x, const void* dy, void* ws, void* out, int n, int c_in,
                  int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? launch_dw<__nv_bfloat16>(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch_dw<float>(x, dy, wsp, op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
