// K2: weight gradient of the SAME stride-1 3x3 convolution in the CHW
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cooperative_training_and_latent_space_data_augmentation_tpu/
// ops/pallas_conv.py:_conv3x3_chw_dw (its pallas_call; _dw_kernel and
// _build_p).  That kernel builds the tap matrix P (9*C_in, H*W) of one image
// in VMEM, with the image edges masked, runs P @ dy^T on the MXU and
// accumulates the (9*C_in, C_out) result across a sequential grid over the
// batch.  This kernel computes the same function,
//
//   dw[t*C_in + i, o] = sum_{n, y, x} x[n, i, (y+ki-1)*W + (x+kj-1)]
//                                     * dy[n, o, y*W + x],   t = 3*ki + kj,
//
// with out-of-image taps reading zero and f32 accumulation, returned in f32.
//
// What bounds it on the H100: each input is read once and the output is
// tiny.  At the main path's bf16 shapes (C_in, C_out <= 64) a pixel carries
// 2*9*C_in*C_out operations on 2*(C_in + C_out) bytes, under the card's 295
// operations a byte, so the ideal kernel is bound by bytes (16->16 @ 192^2,
// batch 20: 47.2 MB, 14 us).  But on the CUDA cores the same products
// cannot take less than 2.8 ms a train step (67 TFLOP/s of f32), so the
// bf16 path runs them on the tensor cores.
//
// bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 out), dw^T (C_out x 9*C_in) = dy (C_out x pixels) . P^T, with the
// pixels as the reduction.  P is never built:
//
//   * A block owns one image, a run of bands ("chunk") and 16 input
//     channels (grid.z covers the rest) for every output channel.  A band is
//     R whole rows (up to 192 columns of them: wider images are cut into
//     column windows).  The block stages x for the band's rows plus a
//     one-row halo above and below, with 8 columns on each side, and dy for
//     its rows, in shared memory with 16-byte cp.async, two stages deep: band
//     b+1 is in flight while the warps run the products on band b.  Halo
//     rows and columns outside the image, channels past C_in or C_out and
//     dy's columns past W are zero in the copy, so every tap reads its
//     zeros from there, as the TPU kernel's edge masks give them, and the
//     product loop has no masks and no branches.
//   * Warp (h, ki), 6 of them, owns kernel row ki and input channels
//     8h..8h+7 of the block's 16: three n-tiles of 8 columns (kj = 0, 1, 2)
//     by every 16-channel m-tile of C_out.  Along an output row, a k-step is
//     16 pixels: A (dy) comes from one ldmatrix.x4 per m-tile; B (x shifted
//     by the tap) from the staged row of lane's channel, where a 32-bit
//     register holds two neighbouring pixels.  The kj = 1 pair is aligned;
//     the kj = 0 and 2 pairs are one bf16 off, so the three taps' fragments
//     come from three aligned loads and two __byte_perm, for each half of
//     the k-step: x is read once from shared memory for all three taps of
//     a kernel row, and staged once from device memory for all 9 taps.
//   * Row and channel pitches are padded so that the fragment loads of a
//     warp hit 32 distinct banks (x) and the ldmatrix rows 8 distinct 16-byte
//     groups (dy).  C_in below 16 leaves the upper channels zero (a block
//     with at most 8 runs its 3 lower warps only); C_out is padded to the
//     m-tile with zero rows.
//   * Accuracy: the tensor cores' f32 accumulation is not FMA-for-FMA IEEE.
//     So each mma chain is two k-steps (32 pixels) and its result is added
//     to the warp's accumulators with an f32 add; the long sums are f32 adds
//     in a fixed order.
//
// f32 stays on the CUDA cores (f32 FMAs, no TF32: the port's f32 convs are
// full f32, see ops/conv_chw.py:full_f32): a block owns one image, one run
// of pixel sub-tiles and up to 16 input channels; each thread owns one input
// channel and four output channels and keeps their 9 taps' 36 sums in
// registers, walking the staged sub-tile's pixels in row order with a 3x3
// window of x that slides along the row.
//
// Both paths: Hopper's blocks run in parallel and in no order, so the TPU
// kernel's sequential accumulation across the grid becomes two passes with a
// fixed summation order and no float atomics.  Each block writes its partial
// (9*C_in, C_out) sums to a workspace slot of its own, (image, chunk), and a
// second kernel, the same for both paths, adds the slots in a fixed order
// (eight interleaved runs of slots, then the eight runs' sums in turn).  The
// result is the same bit
// for bit from run to run; the partition into chunks depends on the shapes
// only (a fixed target of blocks, not the device), so the rounding is the
// same on every card.
//
// C interface (bound with ctypes): conv3x3_chw_dw_workspace(...) gives the
// workspace size in floats (enough for either dtype); conv3x3_chw_dw(...)
// launches both passes on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launches (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_COUT = 64;

// ---------------------------------------------------------------------------
// f32: CUDA cores.

constexpr int CI_T = 16;          // input channels per block; grid.z covers the rest
constexpr int PIX = 96;           // most pixels in one staged sub-tile
constexpr int MAX_TH = 8;         // most rows in one sub-tile
constexpr int XS = 200;           // staged floats per channel: (TH+2)*(TW+2) <= XS
constexpr long long TARGET_BLOCKS = 528;  // about four blocks per SM of an H100

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
template <int COB>
__global__ void __launch_bounds__(CI_T * COB / 4)
dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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
  const float* xn = x + (long long)n * c_in * L;
  const float* dyn = dy + (long long)n * c_out * L;
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
        v = xn[(long long)(i0 + ci) * L + (long long)gy * W + gx];
      s_x[ci * XS + r * sw + c] = v;
    }
    for (int e = tid; e < COB * th * tw; e += NT) {
      const int o = e / (th * tw);
      const int p = e % (th * tw);
      const int r = p / tw;
      const int c = p % tw;
      float v = 0.f;
      if (o < c_out && r < eh && c < ew)
        v = dyn[(long long)o * L + (long long)(y0 + r) * W + x0 + c];
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

// Pass 2 of both paths.  out[e] = sum over the workspace slots p = 0 ..
// parts-1 of ws[p][e] in a fixed order: thread row j of a (32, 8) block adds
// slots j, j+8, ... in turn, then row 0 adds the 8 rows' sums in row order.
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int parts,
                 long long k) {
  __shared__ float part[8][32];
  const long long e = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < k)
    for (int p = threadIdx.y; p < parts; p += 8) s += ws[(long long)p * k + e];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < k) {
    float total = part[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < 8; ++j) total += part[j][threadIdx.x];
    out[e] = total;
  }
}

cudaError_t launch_reduce(const float* ws, float* out, int parts, int c_in, int c_out,
                          cudaStream_t stream) {
  const long long k = 9LL * c_in * c_out;
  dw_reduce_kernel<<<(unsigned)((k + 31) / 32), dim3(32, 8), 0, stream>>>(ws, out, parts, k);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* x, const float* dy, float* ws, float* out, int n,
                       int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, h, w);
  const dim3 grid(g.chunks, n, g.groups);
  if (c_out <= 16)
    dw_partial_kernel<16><<<grid, CI_T * 16 / 4, 0, stream>>>(x, dy, ws, c_in, c_out, h, w, g);
  else if (c_out <= 32)
    dw_partial_kernel<32><<<grid, CI_T * 32 / 4, 0, stream>>>(x, dy, ws, c_in, c_out, h, w, g);
  else
    dw_partial_kernel<64><<<grid, CI_T * 64 / 4, 0, stream>>>(x, dy, ws, c_in, c_out, h, w, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(ws, out, n * g.chunks, c_in, c_out, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.

namespace tc {

constexpr int CG = 16;             // input channels per block; grid.z covers the rest
constexpr int NWARP = 6;           // warp (h, ki) = (warp / 3, warp % 3)
constexpr int NTH = 32 * NWARP;
constexpr int CW_MAX = 192;        // most columns in a band's window
constexpr int XPAD = 8;            // staged x: global column c0 + j at column j + XPAD
constexpr int STAGE_BYTES = 40 * 1024;  // target shared memory of one of the two stages
constexpr int SMS = 132;           // SMs of an H100, each running two blocks

// How the pixels of one image are cut: bands of `rows` rows by a window of
// `wd` columns, `ncw` windows across a row, `bands` in all, `sub` of them
// per block, so `chunks` blocks per image and input-channel group.  In
// shared memory a stage holds x as CG channels of (rows + 2) rows of `wx`
// columns, channel pitch `sx`, and dy as 16*mt channels of `rows` rows of
// `wd` columns, channel pitch `sd`.  lsh_x, lsh_d: log2 of the lanes that
// stage one row of x or dy (16 bytes each).
struct Geometry {
  int mt, wd, wx, ncw, rows, bands, sx, sd, sub, chunks, groups, lsh_x, lsh_d;
  int smem;  // bytes of both stages
};

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }
// The smallest v >= a with v % m == r (0 <= r < m).
constexpr int round_up_to(int a, int m, int r) { return a + ((r - a % m) % m + m) % m; }
inline int log2_lanes(int per_row) {
  int s = 0;
  while (s < 5 && (1 << s) < per_row) ++s;
  return s;
}

// x pitch = 8 mod 64 elements: the 8 channel rows of a fragment load start
// 4 banks apart.  dy pitch an odd multiple of 8 elements: the 8 rows of an
// ldmatrix fall in distinct 16-byte groups.
inline int stage_elems(const Geometry& g, int rows) {
  return CG * round_up_to((rows + 2) * g.wx, 64, 8) + 16 * g.mt * round_up_to(rows * g.wd, 16, 8);
}

Geometry geometry(int n, int c_in, int c_out, int h, int w) {
  Geometry g;
  g.mt = c_out <= 16 ? 1 : (c_out <= 32 ? 2 : 4);
  g.wd = round_up(w, 16) < CW_MAX ? round_up(w, 16) : CW_MAX;
  g.wx = g.wd + 2 * XPAD;
  g.ncw = (w + g.wd - 1) / g.wd;
  g.rows = 1;
  while (g.rows < h && 2 * stage_elems(g, g.rows + 1) <= STAGE_BYTES) ++g.rows;
  g.sx = round_up_to((g.rows + 2) * g.wx, 64, 8);
  g.sd = round_up_to(g.rows * g.wd, 16, 8);
  g.bands = (h + g.rows - 1) / g.rows * g.ncw;
  g.groups = (c_in + CG - 1) / CG;
  // At most 2 * SMS blocks in all, so that one wave runs them.
  const long long per = 2LL * SMS / ((long long)n * g.groups);
  const int most = per < 1 ? 1 : (per > g.bands ? g.bands : (int)per);
  g.sub = (g.bands + most - 1) / most;
  g.chunks = (g.bands + g.sub - 1) / g.sub;
  g.lsh_x = log2_lanes(g.wx / 8);
  g.lsh_d = log2_lanes(g.wd / 8);
  g.smem = 2 * 2 * stage_elems(g, g.rows);
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when bytes == 0 (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(p)));
}

// d = a . b (fresh) or d += a . b; m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 16 pixels for warp (h, ki): t[m][kj] (+)= dy tile m . x tap
// (ki, kj), for output columns c .. c+15 of the window.  xp: the lane's
// staged channel row at window column c + 2q - 2 (an even element), so words
// 0..2 hold columns c+2q-2 .. c+2q+3.  Tap kj needs the pair (c+2q+kj-1,
// c+2q+kj) for b0: word 1 for kj = 1, the halves of words 0|1 or 1|2 for kj =
// 0 or 2.  Words 4..6 hold the same 6 columns 8 on, for b1.  ap: the lane's
// ldmatrix row of m-tile 0 at column c.
template <int MT, bool FRESH>
__device__ __forceinline__ void k_step(float (&t)[MT][3][4], const __nv_bfloat16* xp,
                                       const __nv_bfloat16* ap, int sd) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(xp);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w4 = w[4], w5 = w[5], w6 = w[6];
  const uint32_t b[3][2] = {{__byte_perm(w0, w1, 0x5432), __byte_perm(w4, w5, 0x5432)},
                            {w1, w5},
                            {__byte_perm(w1, w2, 0x5432), __byte_perm(w5, w6, 0x5432)}};
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t a[4];
    ldmatrix_x4(a, ap + m * 16 * sd);
#pragma unroll
    for (int kj = 0; kj < 3; ++kj) {
      if (FRESH)
        mma_fresh(t[m][kj], a, b[kj][0], b[kj][1]);
      else
        mma_acc(t[m][kj], a, b[kj][0], b[kj][1]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void add_into(float (&acc)[MT][3][4], const float (&t)[MT][3][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] += t[m][kj][e];
}

// Stage band (y0, c0) of the block's cg input channels and c_out output
// channels into xs and ds: every element of those channels' rows is written,
// with the image's values or zero.  vec: rows start 16-byte aligned (W % 8
// == 0), so whole 16-byte pieces are in or out of the image and go by
// cp.async; else element by element.
__device__ __forceinline__ void stage_band(__nv_bfloat16* xs, __nv_bfloat16* ds,
                                           const __nv_bfloat16* xn, const __nv_bfloat16* dn,
                                           int cg, int c_out, int H, int W, long long L,
                                           int y0, int c0, const Geometry& g, bool vec,
                                           int warp, int lane) {
  const int r2 = g.rows + 2;
  if (vec) {
    {
      const int per = 32 >> g.lsh_x, step = 1 << g.lsh_x, cpr = g.wx / 8;
      const int j0 = lane & (step - 1);
      for (int row = warp * per + (lane >> g.lsh_x); row < cg * r2; row += NWARP * per) {
        const int ch = row / r2, rr = row - ch * r2;
        const int gy = y0 - 1 + rr;
        const bool row_in = gy >= 0 && gy < H;
        const __nv_bfloat16* src = xn + ch * L + (long long)gy * W;
        __nv_bfloat16* dst = xs + ch * g.sx + rr * g.wx;
        for (int j = j0; j < cpr; j += step) {
          const int gc = c0 - XPAD + 8 * j;
          const bool in = row_in && gc >= 0 && gc < W;
          cp_async16(dst + 8 * j, in ? src + gc : xn, in ? 16 : 0);
        }
      }
    }
    {
      const int per = 32 >> g.lsh_d, step = 1 << g.lsh_d, cpr = g.wd / 8;
      const int j0 = lane & (step - 1);
      for (int row = warp * per + (lane >> g.lsh_d); row < c_out * g.rows;
           row += NWARP * per) {
        const int o = row / g.rows, rr = row - o * g.rows;
        const int gy = y0 + rr;
        const __nv_bfloat16* src = dn + o * L + (long long)gy * W;
        __nv_bfloat16* dst = ds + o * g.sd + rr * g.wd;
        for (int j = j0; j < cpr; j += step) {
          const int gc = c0 + 8 * j;
          const bool in = gy < H && gc < W;
          cp_async16(dst + 8 * j, in ? src + gc : dn, in ? 16 : 0);
        }
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int row = warp; row < cg * r2; row += NWARP) {
      const int ch = row / r2, rr = row - ch * r2;
      const int gy = y0 - 1 + rr;
      const bool row_in = gy >= 0 && gy < H;
      __nv_bfloat16* dst = xs + ch * g.sx + rr * g.wx;
      for (int j = lane; j < g.wx; j += 32) {
        const int gc = c0 - XPAD + j;
        dst[j] = row_in && gc >= 0 && gc < W ? xn[ch * L + (long long)gy * W + gc] : zero;
      }
    }
    for (int row = warp; row < c_out * g.rows; row += NWARP) {
      const int o = row / g.rows, rr = row - o * g.rows;
      const int gy = y0 + rr;
      __nv_bfloat16* dst = ds + o * g.sd + rr * g.wd;
      for (int j = lane; j < g.wd; j += 32) {
        const int gc = c0 + j;
        dst[j] = gy < H && gc < W ? dn[o * L + (long long)gy * W + gc] : zero;
      }
    }
  }
}

// Pass 1.  Grid (chunks, N, groups): the block's partial sums over its
// chunk's bands, for input channels 16*blockIdx.z .. +15 and every output
// channel, written to workspace slot (image, chunk).
template <int MT>
__global__ void __launch_bounds__(NTH, 2)
dw_mma_partial_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ dy, float* __restrict__ ws,
                      int c_in, int c_out, int H, int W, Geometry g, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage = CG * g.sx + 16 * MT * g.sd;  // elements
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(smem);

  // Channels past cg or c_out are never staged: zero them once, with
  // everything else.
  for (int e = threadIdx.x; e < stage / 4; e += NTH)  // 2 stages * 2 B / 16 B
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp / 3, ki = warp - 3 * h;
  const int chunk = blockIdx.x, n = blockIdx.y, i0 = blockIdx.z * CG;
  const int cg = min(CG, c_in - i0);
  const bool active = 8 * h < cg;
  const long long L = (long long)H * W;
  const __nv_bfloat16* xn = x + ((long long)n * c_in + i0) * L;
  const __nv_bfloat16* dn = dy + (long long)n * c_out * L;
  const int b_first = chunk * g.sub, b_end = min(g.bands, b_first + g.sub);

  const int gq = lane >> 2, q = lane & 3;
  const int x_lane = (8 * h + gq) * g.sx + ki * g.wx + 2 * q + XPAD - 2;
  const int a_lane = (lane & 15) * g.sd + (lane >> 4) * 8;

  float acc[MT][3][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] = 0.f;

  auto band_origin = [&](int b, int& y0, int& c0) {
    y0 = (b / g.ncw) * g.rows;
    c0 = (b % g.ncw) * g.wd;
  };
  // Band b_first + s goes to stage s & 1, one commit group each; band b + 1
  // is in flight while band b runs.
  auto stage_ahead = [&](int b) {
    if (b < b_end) {
      int y0, c0;
      band_origin(b, y0, c0);
      __nv_bfloat16* xs = xs0 + ((b - b_first) & 1) * stage;
      stage_band(xs, xs + CG * g.sx, xn, dn, cg, c_out, H, W, L, y0, c0, g, vec, warp, lane);
    }
    cp_async_commit();
  };
  stage_ahead(b_first);
  for (int b = b_first; b < b_end; ++b) {
    stage_ahead(b + 1);     // into the stage band b - 1 left
    cp_async_wait_prior();  // band b has landed
    __syncthreads();
    if (active) {
      int y0, c0;
      band_origin(b, y0, c0);
      const int rows = min(g.rows, H - y0);
      const int cols = min(g.wd, round_up(W - c0, 16));
      const __nv_bfloat16* xs = xs0 + ((b - b_first) & 1) * stage;
      const __nv_bfloat16* xl = xs + x_lane;
      const __nv_bfloat16* al = xs + CG * g.sx + a_lane;
      for (int r = 0; r < rows; ++r) {
        const __nv_bfloat16* xr = xl + r * g.wx;
        const __nv_bfloat16* ar = al + r * g.wd;
        int c = 0;
        for (; c + 32 <= cols; c += 32) {
          float t[MT][3][4];
          k_step<MT, true>(t, xr + c, ar + c, g.sd);
          k_step<MT, false>(t, xr + c + 16, ar + c + 16, g.sd);
          add_into(acc, t);
        }
        if (c < cols) {
          float t[MT][3][4];
          k_step<MT, true>(t, xr + c, ar + c, g.sd);
          add_into(acc, t);
        }
      }
    }
    __syncthreads();  // this stage is free for band b + 2
  }

  // acc[m][kj][e]: output channel 16m + gq (+8 for e >= 2), input channel
  // i0 + 8h + 2q + (e & 1), tap 3*ki + kj (the m16n8 accumulator layout).
  float* wp = ws + ((long long)n * g.chunks + chunk) * 9 * c_in * c_out;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * m + gq + 8 * (e >> 1);
        const int i = i0 + 8 * h + 2 * q + (e & 1);
        if (active && i < c_in && o < c_out)
          wp[((long long)(3 * ki + kj) * c_in + i) * c_out + o] = acc[m][kj][e];
      }
}

// The most shared memory geometry() gives MT m-tiles: both stages of
// one-row bands at the widest window, or of more rows while a stage fits in
// STAGE_BYTES.
constexpr int smem_most(int mt) {
  const int one_row = 2 * (CG * round_up_to(3 * (CW_MAX + 2 * XPAD), 64, 8) +
                           16 * mt * round_up_to(CW_MAX, 16, 8));
  return 2 * (one_row > STAGE_BYTES ? one_row : STAGE_BYTES);
}

// Allows the kernel smem_most(MT) bytes of dynamic shared memory, once for
// each device (the attribute is kept per context).
template <int MT>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(dw_mma_partial_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_most(MT));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int MT>
cudaError_t launch_partial(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* ws,
                           int n, int c_in, int c_out, int h, int w, const Geometry& g,
                           int vec, cudaStream_t stream) {
  if (g.smem > smem_most(MT)) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem<MT>();
  if (err != cudaSuccess) return err;
  dw_mma_partial_kernel<MT><<<dim3(g.chunks, n, g.groups), NTH, g.smem, stream>>>(
      x, dy, ws, c_in, c_out, h, w, g, vec);
  return cudaGetLastError();
}

cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* ws, float* out,
                   int n, int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, c_out, h, w);
  const int vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaError_t err;
  if (g.mt == 1)
    err = launch_partial<1>(x, dy, ws, n, c_in, c_out, h, w, g, vec, stream);
  else if (g.mt == 2)
    err = launch_partial<2>(x, dy, ws, n, c_in, c_out, h, w, g, vec, stream);
  else
    err = launch_partial<4>(x, dy, ws, n, c_in, c_out, h, w, g, vec, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(ws, out, n * g.chunks, c_in, c_out, stream);
}

}  // namespace tc

bool valid(int n, int c_in, int c_out, int h, int w) {
  return n >= 1 && n <= 65535 && c_in >= 1 && c_out >= 1 && c_out <= MAX_COUT &&
         h >= 1 && w >= 1 && (c_in + CI_T - 1) / CI_T <= 65535;
}

}  // namespace

extern "C" {

// Floats of workspace conv3x3_chw_dw needs for these shapes, in either dtype
// (0 if invalid).
long long conv3x3_chw_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  const Geometry g = geometry(n, c_in, h, w);
  const tc::Geometry t = tc::geometry(n, c_in, c_out, h, w);
  const long long slots = (long long)n * (g.chunks > t.chunks ? g.chunks : t.chunks);
  return slots * 9 * c_in * c_out;
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
      is_bf16 ? tc::launch(static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(dy), wsp, op, n, c_in, c_out, h,
                           w, s)
              : launch_f32(static_cast<const float*>(x), static_cast<const float*>(dy), wsp,
                           op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_chw_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
