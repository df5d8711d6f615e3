// K6 and K6dw: the output-blocked (B = 8) SAME stride-1 3x3 convolution for
// small channel counts (C_in >= 8, max(C) <= 64, 8 | W) and its weight
// gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv_blocked.py:conv3x3_b8 (its pallas_call; _b8_kernel and
// _build_p_b8) and _conv3x3_b8_dw (_b8_dw_kernel, then fold_dw_wall).  On the
// TPU a conv with 16 output channels fills 16 of the MXU's 128 lanes, so
// those kernels block 8 consecutive output pixels of an image row into one
// matmul column group,
//
//   out'(HW/8, 8*C_out) = P'(HW/8, 30*C_in) @ W'(30*C_in, 8*C_out),
//
// each P' row holding the 3 x 10 input window of its 8 output pixels, and
// dw accumulates P'^T @ dY' over the images before folding the 30-wide wall
// back to 3 x 3 taps.  These kernels compute the same functions on the
// port's NCHW layout, x (N, C_in, H*W):
//
//   out[n, o, y*W + x]   = sum_{ki, kj, i} w_all[o, (3*ki + kj)*C_in + i]
//                                          * x[n, i, (y+ki-1)*W + (x+kj-1)]
//   dw[t*C_in + i, o]    = sum_{n, y, x} x[n, i, (y+ki-1)*W + (x+kj-1)]
//                                        * dy[n, o, y*W + x],   t = 3*ki + kj
//
// with out-of-image taps reading zero, f32 accumulation, the forward rounded
// once to the input type at the store and dw returned in f32.
//
// What bounds them on the H100: at the B8 bench's stages (16..64 channels,
// 192^2..48^2, batch 20) the bytes (input read once, output written once)
// take longer at 3.35 TB/s than the MACs on the tensor cores, so the ideal
// kernels are bound by bytes.  These run the MACs on the CUDA cores in f32
// (67 TFLOP/s), which makes them bound by operations there; the tensor cores
// are later work.
//
// What the design does about it: the counterpart of the TPU's output
// blocking on CUDA cores is register blocking.  P' and the 30-wide wall are
// never built.
//
//   * K6: a thread owns 8 consecutive output pixels of one row and 8 output
//     channels: 64 f32 sums in registers.  For each input channel it loads
//     the 3 x 10 input window once (30 loads for 72 taps, against 9 loads a
//     pixel for a thread that owns one pixel) and the channel's 9 x 8
//     weights from shared memory (the same address for the whole warp), and
//     does 576 FMAs.  A block is 32 pixel blocks (one a lane) by all output
//     groups (one a warp), so the warps of a block read the same windows
//     and share them in L1.
//   * K6dw: a thread owns one input channel and 8 output channels over all
//     9 taps: 72 f32 sums.  For each pixel block it loads the channel's
//     3 x 10 window and takes the 8 x 8 dy values from a tile staged in
//     shared memory, and does 576 FMAs; the fold over the window columns is
//     implicit, since each tap's sum is kept apart.  Hopper's blocks run in
//     no order, so the TPU kernel's sequential accumulation over images
//     becomes two passes with a fixed summation order and no float atomics:
//     each block sums one slab of pixel blocks of one image into a
//     workspace slot of its own, and a second kernel adds the slots in slot
//     order.  The slabs depend on the shapes only; two launches agree bit
//     for bit.
//
// C interface (bound with ctypes): conv3x3_b8(...) and conv3x3_b8_dw(...)
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError() of the launches (0 on success);
// conv3x3_b8_dw_workspace(...) gives the workspace size in floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int B = 8;        // output pixels a thread owns along a row
constexpr int OG = 8;       // output channels a thread owns
constexpr int MAX_C = 64;   // most channels on either side
constexpr int PB = 32;      // K6: pixel blocks per block, one a lane
constexpr int CK = 16;      // K6: input channels whose weights are staged at once
constexpr int TP = 8;       // K6dw: pixel blocks of dy staged at once
constexpr int DW_THREADS = 256;                // K6dw: most threads a block
constexpr long long DW_TARGET_THREADS = 65536;  // K6dw: about 16 warps an SM

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[B]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[B]) {
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    u[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// The 3 x 10 window of channel plane xc around the pixel block (y, x0 .. x0+7):
// rows y-1 .. y+1, columns x0-1 .. x0+8, zero outside the image.
template <typename T>
__device__ __forceinline__ void load_window(const T* xc, int y, int x0, int H, int W,
                                            float (&win)[3][B + 2]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int sy = y + r - 1;
    const bool row_ok = sy >= 0 && sy < H;
    const T* row = xc + (long long)sy * W;
#pragma unroll
    for (int c = 0; c < B + 2; ++c) {
      const int sx = x0 + c - 1;
      win[r][c] = (row_ok && sx >= 0 && sx < W) ? load_f32(row + sx) : 0.f;
    }
  }
}

// K6.  Grid (ceil(H*W/8 / PB), N), blockDim PB * ceil(C_out / OG).
template <typename T>
__global__ void __launch_bounds__(PB * MAX_C / OG)
conv3x3_b8_kernel(const T* __restrict__ x, const T* __restrict__ w_all,
                  T* __restrict__ out, int c_in, int c_out, int H, int W) {
  __shared__ __align__(16) float s_w[CK][9][MAX_C];
  const int tid = threadIdx.x;
  const int lane = tid % PB;
  const int o0 = (tid / PB) * OG;
  const int cob = (blockDim.x / PB) * OG;  // output channels the block covers
  const int wb = W / B;
  const int pb = blockIdx.x * PB + lane;
  const bool active = pb < H * wb;
  const int y = active ? pb / wb : 0;
  const int x0 = active ? (pb - y * wb) * B : 0;
  const long long L = (long long)H * W;
  const T* xn = x + (long long)blockIdx.y * c_in * L;

  float acc[B][OG];
#pragma unroll
  for (int j = 0; j < B; ++j)
#pragma unroll
    for (int o = 0; o < OG; ++o) acc[j][o] = 0.f;

  for (int c0 = 0; c0 < c_in; c0 += CK) {
    const int ck = min(CK, c_in - c0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int e = tid; e < CK * 9 * cob; e += blockDim.x) {
      const int ci = e / (9 * cob);
      const int t = (e / cob) % 9;
      const int o = e % cob;
      float v = 0.f;
      if (ci < ck && o < c_out) v = load_f32(w_all + (long long)o * 9 * c_in + t * c_in + c0 + ci);
      s_w[ci][t][o] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int ci = 0; ci < ck; ++ci) {
      float win[3][B + 2];
      load_window(xn + (long long)(c0 + ci) * L, y, x0, H, W, win);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 wa = *reinterpret_cast<const float4*>(&s_w[ci][t][o0]);
        const float4 wb4 = *reinterpret_cast<const float4*>(&s_w[ci][t][o0 + 4]);
        const float wv[OG] = {wa.x, wa.y, wa.z, wa.w, wb4.x, wb4.y, wb4.z, wb4.w};
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float v = win[t / 3][j + t % 3];
#pragma unroll
          for (int o = 0; o < OG; ++o) acc[j][o] = fmaf(v, wv[o], acc[j][o]);
        }
      }
    }
  }

  if (!active) return;
  T* on = out + (long long)blockIdx.y * c_out * L + (long long)y * W + x0;
#pragma unroll
  for (int o = 0; o < OG; ++o) {
    if (o0 + o >= c_out) break;
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = acc[j][o];
    store8(on + (long long)(o0 + o) * L, v);
  }
}

// How K6dw cuts the work: input channels in groups of `cig` (one thread
// each, times `ng` output groups), the pixel blocks of an image in slabs of
// `spb` (a multiple of TP), `parts` slabs an image.  Shapes only.
struct Geometry {
  int ng, cig, groups, spb, parts;
};

Geometry geometry(int n, int c_in, int c_out, int h, int w) {
  Geometry g;
  g.ng = (c_out + OG - 1) / OG;
  g.cig = c_in < DW_THREADS / g.ng ? c_in : DW_THREADS / g.ng;
  g.groups = (c_in + g.cig - 1) / g.cig;
  const long long nblocks = (long long)h * (w / B);
  const long long blocks = DW_TARGET_THREADS / ((long long)g.ng * g.cig);
  long long parts = blocks / ((long long)n * g.groups);
  const long long most = (nblocks + TP - 1) / TP;
  if (parts < 1) parts = 1;
  if (parts > most) parts = most;
  long long spb = (nblocks + parts - 1) / parts;
  spb = (spb + TP - 1) / TP * TP;
  g.spb = (int)spb;
  g.parts = (int)((nblocks + spb - 1) / spb);
  return g;
}

// K6dw, pass 1.  Grid (parts, N, groups), blockDim ng * cig: thread tid owns
// input channel i0 + tid / ng and output channels OG * (tid % ng) .. +7 over
// the pixel blocks [spb * z, min(H*W/8, spb * (z+1))) of image n, and writes
// its 9 x 8 sums to workspace slot (n, z).
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
conv3x3_b8_dw_partial(const T* __restrict__ x, const T* __restrict__ dy,
                      float* __restrict__ ws, int c_in, int c_out, int H, int W,
                      Geometry g) {
  // dy of TP pixel blocks, row pixel-block * B + pixel; rows padded so
  // that the staging stores of consecutive pixels spread over the banks
  __shared__ __align__(16) float s_dy[TP * B][MAX_C + 4];
  const int tid = threadIdx.x;
  const int o0 = (tid % g.ng) * OG;
  const int i = blockIdx.z * g.cig + tid / g.ng;
  const int cob = g.ng * OG;
  const int n = blockIdx.y;
  const int wb = W / B;
  const int nblocks = H * wb;
  const int p0 = blockIdx.x * g.spb;
  const int p1 = min(nblocks, p0 + g.spb);
  const long long L = (long long)H * W;
  const T* xc = x + ((long long)n * c_in + (i < c_in ? i : 0)) * L;
  const T* dn = dy + (long long)n * c_out * L;

  float acc[9][OG];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < OG; ++o) acc[t][o] = 0.f;

  for (int pc = p0; pc < p1; pc += TP) {
    const int np = min(TP, p1 - pc);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < TP * B * cob; e += blockDim.x) {
      const int o = e / (TP * B);
      const int pj = e % (TP * B);  // pixel block pj / B, pixel pj % B: contiguous in dy
      float v = 0.f;
      if (o < c_out && pj / B < np) {
        const int pb = pc + pj / B;
        const int y = pb / wb;
        v = load_f32(dn + (long long)o * L + (long long)y * W + (pb - y * wb) * B + pj % B);
      }
      s_dy[pj][o] = v;
    }
    __syncthreads();
    if (i >= c_in) continue;
    for (int k = 0; k < np; ++k) {
      const int pb = pc + k;
      const int y = pb / wb;
      float win[3][B + 2];
      load_window(xc, y, (pb - y * wb) * B, H, W, win);
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const float4 da = *reinterpret_cast<const float4*>(&s_dy[k * B + j][o0]);
        const float4 db = *reinterpret_cast<const float4*>(&s_dy[k * B + j][o0 + 4]);
        const float d[OG] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float v = win[t / 3][j + t % 3];
#pragma unroll
          for (int o = 0; o < OG; ++o) acc[t][o] = fmaf(v, d[o], acc[t][o]);
        }
      }
    }
  }

  if (i >= c_in) return;
  float* wp = ws + ((long long)n * g.parts + blockIdx.x) * 9 * c_in * c_out;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < OG; ++o)
      if (o0 + o < c_out) wp[((long long)t * c_in + i) * c_out + o0 + o] = acc[t][o];
}

// K6dw, pass 2: out[e] = sum over the workspace slots z = 0 .. parts-1 of
// ws[z][e], in slot order.
__global__ void conv3x3_b8_dw_reduce(const float* __restrict__ ws,
                                     float* __restrict__ out, int parts, long long k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  float s = 0.f;
  for (int z = 0; z < parts; ++z) s += ws[(long long)z * k + e];
  out[e] = s;
}

// The shapes both kernels take: the JAX package's b8_eligible for the
// forward conv (8 | W, H >= 2, C_in >= 8, max(C) <= 64), except that the
// input gradient runs K6 with the forward's C_out as its C_in, so here any
// C_in >= 1 passes.
bool valid(int n, int c_in, int c_out, int h, int w) {
  return n >= 1 && n <= 65535 && c_in >= 1 && c_in <= MAX_C && c_out >= 1 &&
         c_out <= MAX_C && h >= 2 && w >= B && w % B == 0 &&
         (long long)h * w <= 0x7fffffffLL && (long long)c_in * h * w <= 0x7fffffffLL &&
         (long long)c_out * h * w <= 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w_all, void* out, int n, int c_in,
                       int c_out, int h, int w, cudaStream_t stream) {
  const long long nblocks = (long long)h * (w / B);
  const dim3 grid((unsigned)((nblocks + PB - 1) / PB), n);
  const int threads = PB * ((c_out + OG - 1) / OG);
  conv3x3_b8_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_all), static_cast<T*>(out), c_in,
      c_out, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, float* ws, float* out, int n, int c_in,
                      int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, c_out, h, w);
  const dim3 grid(g.parts, n, g.groups);
  conv3x3_b8_dw_partial<T><<<grid, g.ng * g.cig, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, c_in, c_out, h, w, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long k = 9LL * c_in * c_out;
  const int threads = 256;
  conv3x3_b8_dw_reduce<<<(unsigned)((k + threads - 1) / threads), threads, 0, stream>>>(
      ws, out, n * g.parts, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, c_in, h*w), w_all: (c_out, 9*c_in) tap-major, out: (n, c_out, h*w),
// all contiguous on the current device, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  Returns a cudaError_t as int.
int conv3x3_b8(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
               int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(x, w_all, out, n, c_in, c_out, h, w, s)
              : launch_fwd<float>(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3_b8_dw needs for these shapes (0 if invalid).
long long conv3x3_b8_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  return (long long)n * geometry(n, c_in, c_out, h, w).parts * 9 * c_in * c_out;
}

// x: (n, c_in, h*w), dy: (n, c_out, h*w), both contiguous on the current
// device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); ws: at least
// conv3x3_b8_dw_workspace(...) floats; out: (9*c_in, c_out) float32, row
// t*c_in + i.  Returns a cudaError_t as int.
int conv3x3_b8_dw(const void* x, const void* dy, void* ws, void* out, int n, int c_in,
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

const char* conv3x3_b8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
