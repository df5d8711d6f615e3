// K2: weight gradient of the SAME stride-1 3x3 convolution in the CHW
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv.py:_conv3x3_chw_dw (its pallas_call; _dw_kernel and
// _build_p).  That kernel builds the tap matrix P (9*C_in, H*W) of one image
// in VMEM, runs P @ dy^T on the MXU and accumulates the (9*C_in, C_out)
// result across a sequential grid over the batch.  This kernel computes the
// same function,
//
//   dw[t*C_in + i, o] = sum_{n, y, x} x[n, i, (y+ki-1)*W + (x+kj-1)]
//                                     * dy[n, o, y*W + x],   t = 3*ki + kj,
//
// with out-of-image taps reading zero and f32 accumulation, returned in f32.
//
// What bounds it on the H100: each input is read once and the output is
// tiny, so the ideal kernel is bound by its 2*9*C_in*C_out MACs per pixel;
// at the main path's bf16 shapes that is under a tenth of a millisecond on
// the tensor cores.  This first design runs the MACs on the CUDA cores in
// f32 (67 TFLOP/s peak) and is bound by operations there; the tensor cores
// are later work.
//
// What the design does about it.  Hopper's blocks run in parallel and in no
// order, so the TPU kernel's sequential accumulation across the grid
// becomes two passes with a fixed summation order and no float atomics:
//
//   1. dw_partial_kernel: a block owns one image, one run of pixel
//      sub-tiles ("chunk") and up to CI_T input channels.  For each
//      sub-tile (TH rows by TW columns) it stages x with a one-pixel halo
//      and dy in shared memory; each thread owns one input channel and four
//      output channels and keeps their 9 taps' 36 sums in registers, walking
//      the sub-tile's pixels in row order with a 3x3 window of x that slides
//      along the row (3 new shared loads a pixel, one float4 of dy, 36 FMAs).
//      It writes its partial (9*C_in, C_out) block to a workspace slot of
//      its own: (image, chunk).
//   2. dw_reduce_kernel: one thread per output element adds the partials in
//      slot order.
//
// The result is the same bit for bit from run to run.  The partition into
// chunks depends on the shapes only (a fixed target of blocks, not the
// device), so the rounding is the same on every card.
//
// C interface (bound with ctypes): conv3x3_chw_dw_workspace(...) gives the
// workspace size in floats; conv3x3_chw_dw(...) launches both passes on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CI_T = 16;          // input channels per block; grid.z covers the rest
constexpr int PIX = 96;           // most pixels in one staged sub-tile
constexpr int MAX_TH = 8;         // most rows in one sub-tile
constexpr int XS = 200;           // staged floats per channel: (TH+2)*(TW+2) <= XS
constexpr long long TARGET_BLOCKS = 528;  // about four blocks per SM of an H100
constexpr int MAX_COUT = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// How the pixels of one image are cut: sub-tiles of th x tw pixels, n_ct
// of them across a row of the image, n_tiles in all, `sub` of them per
// block, so `chunks` blocks per image and input-channel group.
struct Geometry {
  int th, tw, n_ct, n_tiles, sub, chunks, groups;
};

Geometry geometry(int n, int c_in, int h, int w) {
  Geometry g;
  g.tw = w <= 64 ? w : 32;
  g.th = PIX / g.tw < 1 ? 1 : (PIX / g.tw > MAX_TH ? MAX_TH : PIX / g.tw);
  g.n_ct = (w + g.tw - 1) / g.tw;
  g.n_tiles = ((h + g.th - 1) / g.th) * g.n_ct;
  g.groups = (c_in + CI_T - 1) / CI_T;
  const long long total = (long long)n * g.n_tiles * g.groups;
  const long long sub = total / TARGET_BLOCKS;
  g.sub = sub < 1 ? 1 : (int)sub;
  g.chunks = (g.n_tiles + g.sub - 1) / g.sub;
  return g;
}

// COB: C_out rounded up to the bucket the sums are kept for (16, 32 or 64).
// A thread owns input channel i0 + tid / (COB/4) and output channels
// 4*(tid % (COB/4)) .. +3; sums for o >= C_out see dy = 0 and are not stored.
template <typename T, int COB>
__global__ void __launch_bounds__(CI_T * COB / 4)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ ws, int c_in, int c_out, int H, int W,
                  Geometry g) {
  constexpr int NT = CI_T * COB / 4;
  constexpr int DS = COB + 4;  // dy row stride: float4-aligned, fewer bank conflicts
  __shared__ float s_x[CI_T * XS];
  __shared__ __align__(16) float s_dy[PIX * DS];

  const int tid = threadIdx.x;
  const int q = tid % (COB / 4);
  const int il = tid / (COB / 4);
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int i0 = blockIdx.z * CI_T;
  const int i = i0 + il;
  const long long L = (long long)H * W;
  const T* xn = x + (long long)n * c_in * L;
  const T* dyn = dy + (long long)n * c_out * L;
  const int th = g.th, tw = g.tw, sw = g.tw + 2;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  const int s_end = min(g.n_tiles, (chunk + 1) * g.sub);
  for (int s = chunk * g.sub; s < s_end; ++s) {
    const int y0 = (s / g.n_ct) * th;
    const int x0 = (s % g.n_ct) * tw;
    const int eh = min(th, H - y0);  // rows and columns of the sub-tile in the image
    const int ew = min(tw, W - x0);
    __syncthreads();  // the previous sub-tile is no longer read
    for (int e = tid; e < CI_T * (th + 2) * sw; e += NT) {
      const int ci = e / ((th + 2) * sw);
      const int r = (e / sw) % (th + 2);
      const int c = e % sw;
      const int gy = y0 + r - 1;
      const int gx = x0 + c - 1;
      float v = 0.f;
      if (i0 + ci < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load_f32(xn + (long long)(i0 + ci) * L + (long long)gy * W + gx);
      s_x[ci * XS + r * sw + c] = v;
    }
    for (int e = tid; e < COB * th * tw; e += NT) {
      const int o = e / (th * tw);
      const int p = e % (th * tw);
      const int r = p / tw;
      const int c = p % tw;
      float v = 0.f;
      if (o < c_out && r < eh && c < ew)
        v = load_f32(dyn + (long long)o * L + (long long)(y0 + r) * W + x0 + c);
      s_dy[p * DS + o] = v;
    }
    __syncthreads();
    if (i < c_in) {
      const float* xs = s_x + il * XS;
      for (int r = 0; r < eh; ++r) {
        float a[3][3];
#pragma unroll
        for (int kr = 0; kr < 3; ++kr) {
          a[kr][0] = xs[(r + kr) * sw];
          a[kr][1] = xs[(r + kr) * sw + 1];
        }
        for (int c = 0; c < ew; ++c) {
#pragma unroll
          for (int kr = 0; kr < 3; ++kr) a[kr][2] = xs[(r + kr) * sw + c + 2];
          const float4 d =
              *reinterpret_cast<const float4*>(&s_dy[(r * tw + c) * DS + 4 * q]);
#pragma unroll
          for (int kr = 0; kr < 3; ++kr)
#pragma unroll
            for (int kc = 0; kc < 3; ++kc) {
              float* at = acc[3 * kr + kc];
              const float v = a[kr][kc];
              at[0] = fmaf(v, d.x, at[0]);
              at[1] = fmaf(v, d.y, at[1]);
              at[2] = fmaf(v, d.z, at[2]);
              at[3] = fmaf(v, d.w, at[3]);
            }
#pragma unroll
          for (int kr = 0; kr < 3; ++kr) {
            a[kr][0] = a[kr][1];
            a[kr][1] = a[kr][2];
          }
        }
      }
    }
  }

  if (i < c_in) {
    float* wp = ws + ((long long)n * g.chunks + chunk) * 9 * c_in * c_out;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * q + k;
        if (o < c_out) wp[((long long)t * c_in + i) * c_out + o] = acc[t][k];
      }
  }
}

// out[e] = sum over the workspace slots p = 0 .. parts-1 of ws[p][e], in
// slot order.
__global__ void dw_reduce_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, int parts,
                                 long long k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += ws[(long long)p * k + e];
  out[e] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* ws, float* out, int n,
                   int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, h, w);
  const dim3 grid(g.chunks, n, g.groups);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  if (c_out <= 16)
    dw_partial_kernel<T, 16><<<grid, CI_T * 16 / 4, 0, stream>>>(xp, dp, ws, c_in, c_out, h, w, g);
  else if (c_out <= 32)
    dw_partial_kernel<T, 32><<<grid, CI_T * 32 / 4, 0, stream>>>(xp, dp, ws, c_in, c_out, h, w, g);
  else
    dw_partial_kernel<T, 64><<<grid, CI_T * 64 / 4, 0, stream>>>(xp, dp, ws, c_in, c_out, h, w, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long k = 9LL * c_in * c_out;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((k + threads - 1) / threads), threads, 0, stream>>>(
      ws, out, n * g.chunks, k);
  return cudaGetLastError();
}

bool valid(int n, int c_in, int c_out, int h, int w) {
  return n >= 1 && n <= 65535 && c_in >= 1 && c_out >= 1 && c_out <= MAX_COUT &&
         h >= 1 && w >= 1 && (c_in + CI_T - 1) / CI_T <= 65535;
}

}  // namespace

extern "C" {

// Floats of workspace conv3x3_chw_dw needs for these shapes (0 if invalid).
long long conv3x3_chw_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  const Geometry g = geometry(n, c_in, h, w);
  return (long long)n * g.chunks * 9 * c_in * c_out;
}

// x: (n, c_in, h*w), dy: (n, c_out, h*w), both contiguous on the current
// device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); ws: at least
// conv3x3_chw_dw_workspace(...) floats; out: (9*c_in, c_out) float32, row
// t*c_in + i.  Returns a cudaError_t as int.
int conv3x3_chw_dw(const void* x, const void* dy, void* ws, void* out, int n,
                   int c_in, int c_out, int h, int w, int is_bf16,
                   void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch<float>(x, dy, wsp, op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_chw_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
