// K4, K4dx and K4dw: the stride-2 pad-1 3x3 convolution and its input and
// weight gradients, in the NCHW layout, for Hopper (sm_90a).
//
// Replace the TPU kernels of cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv.py: conv3x3s2_phase (K4; _conv_s2_kernel, _build_p_s2),
// _conv3x3s2_phase_dx (K4dx; _dx_s2_kernel) and _conv3x3s2_phase_dw (K4dw;
// _dw_s2_kernel).  Those take the input split into its four parity phases
// (chw_phase_split: (N, 4*C_in, H/2*W/2)), a relayout that stood in for an
// NHWC transpose on the TPU, build the tap matrix P (9*C_in, H/2*W/2) of one
// image from shifted phases and run one MXU product per image.  Here there is
// no transpose to replace, so the kernels read and write NCHW directly with
// stride-2 indexing and no phase split.  They compute, with f32 accumulation,
//
//   K4:   out[n, o, r, c] = sum_{ki, kj, i} w_all[o, (3*ki + kj)*C_in + i]
//                                          * x[n, i, 2r+ki-1, 2c+kj-1]
//   K4dx: dx[n, i, y, x]  = sum over (o, r, c, ki, kj) with 2r+ki-1 = y and
//                           2c+kj-1 = x of w_all[o, t*C_in + i] * dy[n, o, r, c]
//   K4dw: dw[t*C_in + i, o] = sum_{n, r, c} x[n, i, 2r+ki-1, 2c+kj-1] * dy[n, o, r, c]
//
// with out-of-image taps reading zero, H and W even, (r, c) over the
// (H/2, W/2) output.  K4 and K4dx round once to the input type at the
// store; K4dw returns f32.
//
// What bounds them on the H100: at the main path's shapes (16->16 on 192^2,
// 32->32 on 96^2) each moves a few MB and does 2*9*C_in*C_out MACs per
// output pixel; on the tensor cores the bytes would bound them.  This first
// design runs the MACs on the CUDA cores in f32 (67 TFLOP/s peak), so it is
// bound by operations there; mma/wgmma is later work.
//
// What the designs do about it:
//
//   K4 (conv3x3s2_fwd_kernel) is K1's design at stride 2: a block owns one
//   image and a TH x TW tile of output pixels, one thread per pixel, all
//   C_out (<= 64) sums in registers.  It stages CK input channels of the
//   (2TH+1) x (2TW+1) input window of its tile in shared memory (zero
//   outside the image), and the matching weights, so each input pixel is
//   read from device memory about once.
//
//   K4dx (conv3x3s2_dx_kernel) is a gather, not a scatter, so it needs no
//   atomics: a thread owns the 2x2 quad of input pixels (2r+py, 2c+px) for
//   16 input channels.  The four pixels of a quad are reached by exactly the
//   nine taps, from the four dy values at (r, c), (r, c+1), (r+1, c) and
//   (r+1, c+1): pixel (even, even) by tap (1,1) only, (even, odd) by two,
//   (odd, even) by two, (odd, odd) by four.  grid.z covers images and groups
//   of 16 input channels; the output channels are staged CK at a time.
//
//   K4dw is K2's design (csrc/conv3x3_chw_dw.cu) on the stride-2 windows:
//   a block owns one image, one run of output sub-tiles ("chunk") and up to
//   16 input channels; a thread owns one input channel and four output
//   channels and keeps their 9 taps' 36 sums in registers.  It writes its
//   partial (9*C_in, C_out) block to a workspace slot of its own, (image,
//   chunk), and conv3x3s2_dw_reduce_kernel adds the slots in order.  No
//   float atomics: two runs agree bit for bit, and the partition depends
//   on the shapes only, so the rounding is the same on every card.
//
// C interface (bound with ctypes): each launcher runs on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError() of
// its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_COUT = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------------ K4

constexpr int F_TW = 32;              // output tile width: one warp per tile row
constexpr int F_TH = 8;               // output tile height
constexpr int F_NT = F_TW * F_TH;     // threads per block
constexpr int F_CK = 4;               // input channels staged per pass
constexpr int F_SW = 2 * F_TW + 1;    // staged input window width
constexpr int F_SH = 2 * F_TH + 1;    // staged input window height

// COB: C_out rounded up to the bucket the sums are kept for (16, 32 or 64).
// Sums for o >= C_out see zero weights and are not stored.
template <typename T, int COB>
__global__ void __launch_bounds__(F_NT)
conv3x3s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_all,
                     T* __restrict__ out, int c_in, int c_out, int H, int W) {
  __shared__ float s_x[F_CK][F_SH][F_SW];
  __shared__ __align__(16) float s_w[F_CK][9][COB];

  const int H2 = H / 2, W2 = W / 2;
  const int tid = threadIdx.x;
  const int tx = tid % F_TW;
  const int ty = tid / F_TW;
  const int c0 = blockIdx.x * F_TW;
  const int r0 = blockIdx.y * F_TH;
  const int iy0 = 2 * r0 - 1;  // input row of s_x[.][0]
  const int ix0 = 2 * c0 - 1;  // input column of s_x[.][.][0]
  const long long L = (long long)H * W;
  const T* xn = x + (long long)blockIdx.z * c_in * L;

  float acc[COB];
#pragma unroll
  for (int o = 0; o < COB; ++o) acc[o] = 0.f;

  for (int i0 = 0; i0 < c_in; i0 += F_CK) {
    const int ck = min(F_CK, c_in - i0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < F_CK * F_SH * F_SW; e += F_NT) {
      const int ci = e / (F_SH * F_SW);
      const int a = (e / F_SW) % F_SH;
      const int b = e % F_SW;
      const int gy = iy0 + a;
      const int gx = ix0 + b;
      float v = 0.f;
      if (ci < ck && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load_f32(xn + (long long)(i0 + ci) * L + (long long)gy * W + gx);
      s_x[ci][a][b] = v;
    }
    for (int e = tid; e < F_CK * 9 * COB; e += F_NT) {
      const int ci = e / (9 * COB);
      const int t = (e / COB) % 9;
      const int o = e % COB;
      float v = 0.f;
      if (ci < ck && o < c_out)
        v = load_f32(w_all + (long long)o * 9 * c_in + t * c_in + i0 + ci);
      s_w[ci][t][o] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < ck; ++ci) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = s_x[ci][2 * ty + t / 3][2 * tx + t % 3];
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

  const int r = r0 + ty;
  const int c = c0 + tx;
  if (r < H2 && c < W2) {
    const long long L4 = (long long)H2 * W2;
    T* on = out + (long long)blockIdx.z * c_out * L4 + (long long)r * W2 + c;
#pragma unroll
    for (int o = 0; o < COB; ++o)
      if (o < c_out) store_from_f32(on + (long long)o * L4, acc[o]);
  }
}

// ---------------------------------------------------------------- K4dx

constexpr int D_TW = 32;              // quads per tile row: one warp
constexpr int D_TH = 8;               // quad rows per tile
constexpr int D_NT = D_TW * D_TH;     // threads per block
constexpr int D_CK = 16;              // output channels staged per pass
constexpr int D_CIG = 16;             // input channels per block; grid.z covers the rest

template <typename T>
__global__ void __launch_bounds__(D_NT)
conv3x3s2_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w_all,
                    T* __restrict__ dx, int c_in, int c_out, int H, int W,
                    int groups) {
  __shared__ float s_dy[D_CK][D_TH + 1][D_TW + 1];
  __shared__ float s_w[D_CK][9][D_CIG];

  const int H2 = H / 2, W2 = W / 2;
  const int tid = threadIdx.x;
  const int tx = tid % D_TW;
  const int ty = tid / D_TW;
  const int c0 = blockIdx.x * D_TW;
  const int r0 = blockIdx.y * D_TH;
  const int n = blockIdx.z / groups;
  const int i0 = (blockIdx.z % groups) * D_CIG;
  const long long L4 = (long long)H2 * W2;
  const T* dyn = dy + (long long)n * c_out * L4;

  // acc[p][i]: input pixel (2r + p / 2, 2c + p % 2), input channel i0 + i
  float acc[4][D_CIG];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < D_CIG; ++i) acc[p][i] = 0.f;

  for (int o0 = 0; o0 < c_out; o0 += D_CK) {
    const int ck = min(D_CK, c_out - o0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < D_CK * (D_TH + 1) * (D_TW + 1); e += D_NT) {
      const int o = e / ((D_TH + 1) * (D_TW + 1));
      const int a = (e / (D_TW + 1)) % (D_TH + 1);
      const int b = e % (D_TW + 1);
      const int r = r0 + a;
      const int c = c0 + b;
      float v = 0.f;
      if (o < ck && r < H2 && c < W2)
        v = load_f32(dyn + (long long)(o0 + o) * L4 + (long long)r * W2 + c);
      s_dy[o][a][b] = v;
    }
    for (int e = tid; e < D_CK * 9 * D_CIG; e += D_NT) {
      const int o = e / (9 * D_CIG);
      const int t = (e / D_CIG) % 9;
      const int i = e % D_CIG;
      float v = 0.f;
      if (o < ck && i0 + i < c_in)
        v = load_f32(w_all + (long long)(o0 + o) * 9 * c_in + t * c_in + i0 + i);
      s_w[o][t][i] = v;
    }
    __syncthreads();
    for (int o = 0; o < ck; ++o) {
      const float d00 = s_dy[o][ty][tx];
      const float d01 = s_dy[o][ty][tx + 1];
      const float d10 = s_dy[o][ty + 1][tx];
      const float d11 = s_dy[o][ty + 1][tx + 1];
      // tap t of channel i is wi[t * D_CIG]; the taps reaching each pixel
      // of the quad are listed in the header
#pragma unroll
      for (int i = 0; i < D_CIG; ++i) {
        const float* wi = &s_w[o][0][i];
        acc[0][i] = fmaf(wi[4 * D_CIG], d00, acc[0][i]);
        acc[1][i] = fmaf(wi[3 * D_CIG], d01, fmaf(wi[5 * D_CIG], d00, acc[1][i]));
        acc[2][i] = fmaf(wi[1 * D_CIG], d10, fmaf(wi[7 * D_CIG], d00, acc[2][i]));
        acc[3][i] = fmaf(wi[0], d11,
                         fmaf(wi[2 * D_CIG], d10,
                              fmaf(wi[6 * D_CIG], d01, fmaf(wi[8 * D_CIG], d00, acc[3][i]))));
      }
    }
  }

  const int r = r0 + ty;
  const int c = c0 + tx;
  if (r < H2 && c < W2) {
    const long long L = (long long)H * W;
    T* dn = dx + (long long)n * c_in * L;
#pragma unroll
    for (int i = 0; i < D_CIG; ++i) {
      if (i0 + i >= c_in) break;
      T* di = dn + (long long)(i0 + i) * L;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        store_from_f32(di + (long long)(2 * r + p / 2) * W + 2 * c + p % 2, acc[p][i]);
    }
  }
}

// ---------------------------------------------------------------- K4dw

constexpr int CI_T = 16;          // input channels per block; grid.z covers the rest
constexpr int PIX = 64;           // most output pixels in one staged sub-tile
constexpr int MAX_TH = 4;         // most output rows in one sub-tile
constexpr int XS = 400;           // staged floats per channel: (2th+1)*(2tw+1) <= XS
constexpr long long TARGET_BLOCKS = 528;  // about four blocks per SM of an H100

// How the output pixels of one image are cut: sub-tiles of th x tw output
// pixels, n_ct of them across a row, n_tiles in all, `sub` of them per
// block, so `chunks` blocks per image and input-channel group.
struct Geometry {
  int th, tw, n_ct, n_tiles, sub, chunks, groups;
};

Geometry geometry(int n, int c_in, int h, int w) {
  const int h2 = h / 2, w2 = w / 2;
  Geometry g;
  g.tw = w2 <= 64 ? w2 : 32;
  g.th = PIX / g.tw < 1 ? 1 : (PIX / g.tw > MAX_TH ? MAX_TH : PIX / g.tw);
  g.n_ct = (w2 + g.tw - 1) / g.tw;
  g.n_tiles = ((h2 + g.th - 1) / g.th) * g.n_ct;
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
conv3x3s2_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            float* __restrict__ ws, int c_in, int c_out, int H,
                            int W, Geometry g) {
  constexpr int NT = CI_T * COB / 4;
  constexpr int DS = COB + 4;  // dy row stride: float4-aligned, fewer bank conflicts
  __shared__ float s_x[CI_T * XS];
  __shared__ __align__(16) float s_dy[PIX * DS];

  const int H2 = H / 2, W2 = W / 2;
  const int tid = threadIdx.x;
  const int q = tid % (COB / 4);
  const int il = tid / (COB / 4);
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int i0 = blockIdx.z * CI_T;
  const int i = i0 + il;
  const long long L = (long long)H * W;
  const long long L4 = (long long)H2 * W2;
  const T* xn = x + (long long)n * c_in * L;
  const T* dyn = dy + (long long)n * c_out * L4;
  const int th = g.th, tw = g.tw;
  const int sh = 2 * th + 1, sw = 2 * tw + 1;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  const int s_end = min(g.n_tiles, (chunk + 1) * g.sub);
  for (int s = chunk * g.sub; s < s_end; ++s) {
    const int r0 = (s / g.n_ct) * th;
    const int c0 = (s % g.n_ct) * tw;
    const int eh = min(th, H2 - r0);  // output rows and columns of the sub-tile
    const int ew = min(tw, W2 - c0);
    __syncthreads();  // the previous sub-tile is no longer read
    for (int e = tid; e < CI_T * sh * sw; e += NT) {
      const int ci = e / (sh * sw);
      const int a = (e / sw) % sh;
      const int b = e % sw;
      const int gy = 2 * r0 - 1 + a;
      const int gx = 2 * c0 - 1 + b;
      float v = 0.f;
      if (i0 + ci < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load_f32(xn + (long long)(i0 + ci) * L + (long long)gy * W + gx);
      s_x[ci * XS + a * sw + b] = v;
    }
    for (int e = tid; e < COB * th * tw; e += NT) {
      const int o = e / (th * tw);
      const int p = e % (th * tw);
      const int r = p / tw;
      const int c = p % tw;
      float v = 0.f;
      if (o < c_out && r < eh && c < ew)
        v = load_f32(dyn + (long long)o * L4 + (long long)(r0 + r) * W2 + c0 + c);
      s_dy[p * DS + o] = v;
    }
    __syncthreads();
    if (i < c_in) {
      const float* xs = s_x + il * XS;
      for (int r = 0; r < eh; ++r) {
        // the 3x3 window of output pixel (r, c) starts at staged (2r, 2c);
        // moving c by one moves it two columns, so column 2 becomes column 0
        float a[3][3];
#pragma unroll
        for (int kr = 0; kr < 3; ++kr) a[kr][2] = xs[(2 * r + kr) * sw];
        for (int c = 0; c < ew; ++c) {
#pragma unroll
          for (int kr = 0; kr < 3; ++kr) {
            a[kr][0] = a[kr][2];
            a[kr][1] = xs[(2 * r + kr) * sw + 2 * c + 1];
            a[kr][2] = xs[(2 * r + kr) * sw + 2 * c + 2];
          }
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
__global__ void conv3x3s2_dw_reduce_kernel(const float* __restrict__ ws,
                                           float* __restrict__ out, int parts,
                                           long long k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += ws[(long long)p * k + e];
  out[e] = s;
}

// ------------------------------------------------------------ launchers

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w_all, void* out, int n,
                       int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const dim3 grid((w / 2 + F_TW - 1) / F_TW, (h / 2 + F_TH - 1) / F_TH, n);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w_all);
  T* op = static_cast<T*>(out);
  if (c_out <= 16)
    conv3x3s2_fwd_kernel<T, 16><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else if (c_out <= 32)
    conv3x3s2_fwd_kernel<T, 32><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else
    conv3x3s2_fwd_kernel<T, 64><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* dy, const void* w_all, void* dx, int n,
                      int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const int groups = (c_in + D_CIG - 1) / D_CIG;
  const dim3 grid((w / 2 + D_TW - 1) / D_TW, (h / 2 + D_TH - 1) / D_TH, n * groups);
  conv3x3s2_dx_kernel<T><<<grid, D_NT, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w_all), static_cast<T*>(dx),
      c_in, c_out, h, w, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, float* ws, float* out,
                      int n, int c_in, int c_out, int h, int w,
                      cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, h, w);
  const dim3 grid(g.chunks, n, g.groups);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  if (c_out <= 16)
    conv3x3s2_dw_partial_kernel<T, 16><<<grid, CI_T * 16 / 4, 0, stream>>>(
        xp, dp, ws, c_in, c_out, h, w, g);
  else if (c_out <= 32)
    conv3x3s2_dw_partial_kernel<T, 32><<<grid, CI_T * 32 / 4, 0, stream>>>(
        xp, dp, ws, c_in, c_out, h, w, g);
  else
    conv3x3s2_dw_partial_kernel<T, 64><<<grid, CI_T * 64 / 4, 0, stream>>>(
        xp, dp, ws, c_in, c_out, h, w, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long k = 9LL * c_in * c_out;
  const int threads = 256;
  conv3x3s2_dw_reduce_kernel<<<(unsigned)((k + threads - 1) / threads), threads, 0,
                               stream>>>(ws, out, n * g.chunks, k);
  return cudaGetLastError();
}

// Shapes every launcher takes: H and W even, C_out <= 64, grids in range.
bool valid(int n, int c_in, int c_out, int h, int w) {
  return n >= 1 && c_in >= 1 && c_out >= 1 && c_out <= MAX_COUT && h >= 2 &&
         w >= 2 && h % 2 == 0 && w % 2 == 0 &&
         (long long)n * ((c_in + D_CIG - 1) / D_CIG) <= 65535 &&
         (h / 2 + F_TH - 1) / F_TH <= 65535;
}

}  // namespace

extern "C" {

// K4.  x: (n, c_in, h*w), w_all: (c_out, 9*c_in) tap-major, out: (n, c_out,
// h/2*w/2), all contiguous on the current device, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1).  Returns a cudaError_t as int.
int conv3x3s2(const void* x, const void* w_all, void* out, int n, int c_in,
              int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(x, w_all, out, n, c_in, c_out, h, w, s)
              : launch_fwd<float>(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// K4dx.  dy: (n, c_out, h/2*w/2), w_all: (c_out, 9*c_in), dx: (n, c_in,
// h*w), as above.  Returns a cudaError_t as int.
int conv3x3s2_dx(const void* dy, const void* w_all, void* dx, int n, int c_in,
                 int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dx<__nv_bfloat16>(dy, w_all, dx, n, c_in, c_out, h, w, s)
              : launch_dx<float>(dy, w_all, dx, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3s2_dw needs for these shapes (0 if invalid).
long long conv3x3s2_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  const Geometry g = geometry(n, c_in, h, w);
  return (long long)n * g.chunks * 9 * c_in * c_out;
}

// K4dw.  x: (n, c_in, h*w), dy: (n, c_out, h/2*w/2), as above; ws: at least
// conv3x3s2_dw_workspace(...) floats; out: (9*c_in, c_out) float32, row
// t*c_in + i.  Returns a cudaError_t as int.
int conv3x3s2_dw(const void* x, const void* dy, void* ws, void* out, int n,
                 int c_in, int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? launch_dw<__nv_bfloat16>(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch_dw<float>(x, dy, wsp, op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3s2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
