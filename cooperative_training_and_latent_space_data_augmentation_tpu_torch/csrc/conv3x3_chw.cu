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
// the input type at the store.  K1's input gradient is this kernel on the
// flipped, transposed wall (ops/conv_chw.py:conv3x3_chw_dx).
//
// What bounds it on the H100: at the main path's bf16 shapes (C_in, C_out
// <= 64, 24^2..192^2 pixels) an output pixel carries 2*9*C_in*C_out
// operations on 2*(C_in + C_out) bytes, at most 288 operations a byte,
// under the card's 295 for bf16 on the tensor cores: the ideal kernel is
// bound by bytes (16->16 @ 192^2, batch 20: 47.2 MB, 14 us).  On the CUDA
// cores in f32 the same products take at least 3.4 ms of a train step's
// forward convs (230 GFLOP at 67 TFLOP/s), so the bf16 path runs them on the
// tensor cores.
//
// bf16, C_in > 8: an implicit GEMM on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 out), out (C_out x pixels) = wall (C_out x 9*C_in) . P, with
// M = 16 output channels, N = 8 neighbouring output pixels of one row, and a
// k-step = 16 input channels of one tap.  P is never built:
//
//   * A tile is a band of whole output rows of one column window (at most
//     64 columns: wider images are cut into windows).  A block walks a run
//     of tiles, each in stages of 16 input channels, for one or two m-tiles
//     of C_out (grid.y covers the rest); the grid holds as many blocks as
//     the SMs take at once, so the walk, not a second wave, covers the rest.
//     The band's height comes from the shapes alone: two 8-warp blocks must
//     fit an SM, and small images are cut into more, shorter bands.
//   * A fragment register of B holds two neighbouring channels of one pixel,
//     while CHW keeps a channel's pixels contiguous, so x is transposed once
//     per stage to a channel-innermost tile xs: pixel (r, s) of the band's
//     rows plus a one-pixel halo at (r*SWP + s)*24, its 16 channels padded to
//     24 (48 bytes).  The 8 pixel rows of an ldmatrix then fall in 8 distinct
//     16-byte bank groups, and a one-pixel tap shift is +48 bytes, still
//     aligned: every B fragment of every tap is one ldmatrix.x4 (two n-tiles)
//     with no shuffles or masks.  x is read from device memory once per
//     block for all 9 taps and the block's output channels.
//   * Staging: cp.async cannot transpose, so 16-byte cp.async pieces of the
//     raw CHW rows land in a buffer (8-column halo pieces included), and
//     ldmatrix.x4.trans turns 8 channel rows of a piece into each lane's
//     channel pairs of one pixel, four 32-bit stores into xs (shared to
//     shared).  This was chosen over loading through registers: no registers
//     hold copies in flight (the accumulators need them), the copies stay
//     asynchronous, and two landing buffers keep the next two stages in
//     flight while the warps run this one.  The wall's slices of 16 channels
//     need no transpose: they go by cp.async to rows of one tap (A fragments
//     by ldmatrix.x4) and stay for the block's walk while C_in <= 64.
//   * Edges as data: halo rows and columns outside the image, channels past
//     C_in and wall rows past C_out are zero in the staged copy (cp.async
//     with a source size of 0), so the product loop has no masks.  Rows that
//     do not start 16-byte aligned (W not a multiple of 8), or a wall whose
//     rows do not (C_in not a multiple of 8), are staged element by element.
//   * Warp w owns n-tiles w, w + warps, ... of a band for the block's
//     m-tiles: 8 with one m-tile, 6 with two, 32 or 48 f32 accumulators a
//     thread, so that the kernel fits 128 registers and two 8-warp blocks an
//     SM.  At a tile's end the sums go through shared memory and leave as
//     16-byte stores, one output row of the window to a group of lanes.
//   * Accuracy: one mma chain per output over its 9*ceil(C_in/16) k-steps
//     (at most 36 at C_in 64), against K2's 737,280 products a weight; no
//     atomics, so two launches agree bit for bit.
//   * What still holds it back (PERF.md): its products re-read each B
//     fragment from shared memory for each of the 9 taps, and the staging's
//     transposing pass and the output's pass through shared memory run
//     between the products, not beside them.
//
// bf16 with C_in <= 8 (the image encoder's 1->16 and the shape encoder's
// 4->16 at 192^2) and f32 stay on the CUDA cores: one thread owns one output
// pixel of a 32 x 8 tile and keeps all C_out (<= 64) sums in registers; a
// chunk of 8 input channels of the tile plus a one-pixel halo, and the
// matching weights, are staged in shared memory as f32.  Padding C_in <= 8
// to a 16-channel k-step would cost the staging more than the products
// save.  f32 stays off the tensor cores because the port's f32 convs are full
// f32 (ops/conv_chw.py:full_f32), and the tensor cores' f32 input is TF32.
//
// C interface (bound with ctypes): conv3x3_chw(...) launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// ---------------------------------------------------------------------------
// bf16 with C_in > 8: tensor cores.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int CC_MAX_CIN = 8;     // C_in up to this stays on the CUDA cores
constexpr int CG = 16;            // input channels per k-step
constexpr int CP = 24;            // staged channels per pixel: CG + 8 of padding (48 bytes)
// n-tiles (8 output pixels each) a warp owns: 8 with one m-tile, 6 with two
// (48 accumulators, so that the kernel fits 128 registers a thread)
__host__ __device__ constexpr int ntw(int mw) { return mw == 1 ? 8 : 6; }
constexpr int MAX_WARPS = 8;
constexpr int WIN = 64;           // most output columns of a window
constexpr int SMS = 132;          // SMs of an H100
constexpr int TARGET_BLOCKS = 2 * SMS;  // bands short enough for this many tiles
constexpr int SMEM_MOST = 113 * 1024;   // so that two blocks fit an SM
constexpr int MAX_WSLOTS = 4;     // wall slices kept; C_in <= 64 keeps all of them

// How the pixels are cut, and the shared memory of a block.  A tile is a
// band of `rows` output rows of a window of `wd` columns (`cpr` chunks of
// 8): `ncw` windows across a row, `bands` bands down a window, `total`
// tiles over the batch.  Block b along grid.x walks tiles b*per .. +per-1
// (in image, band, window order), each in `groups` stages of 16 input
// channels; along grid.y (`mz` blocks) it owns `mw` m-tiles of 16 output
// channels.  It runs `warps` warps.  Shared memory holds:
//   * the wall: `wslots` slices of 9 taps x 16*mw rows x CP;
//   * xs: (rows + 2) rows of `swp` pixels x CP, and at a tile's end its
//     outputs, 16*mw rows of `opitch` elements;
//   * two landing buffers: 16 channel rows (pitch `lpc` pieces) of
//     (rows + 2) rows of `lp` 16-byte pieces.
//   lsh_l, lsh_o: log2 of the lanes that land one row of pieces (lp) or
// store one output row (cpr pieces); cpr_mul: t / cpr = (t * cpr_mul) >> 16
// for the band's n-tiles t.
struct Geometry {
  int mw, mz, wd, cpr, ncw, rows, bands, total, per, blocks, warps, groups, wslots;
  int swp, opitch, lp, lpc, lsh_l, lsh_o, cpr_mul;
  int xs_off, land_off, land_bytes, smem;  // bytes
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int log2_lanes(int per_row) {
  int k = 0;
  while (k < 5 && (1 << k) < per_row) ++k;
  return k;
}

void layout(Geometry& g) {
  const int r2 = g.rows + 2;
  g.swp = g.wd + 3;                                    // odd: see transpose_x
  g.opitch = ceil_div(g.rows * g.wd, 64) * 64 + 8;     // 4 words past a multiple of 32
  g.lp = g.cpr + 2;
  g.lpc = (r2 * g.lp) | 1;                             // odd: see transpose_x
  g.xs_off = g.wslots * 9 * 16 * g.mw * CP * 2;
  const int xs = r2 * g.swp * CP, outs = 16 * g.mw * g.opitch;
  g.land_off = g.xs_off + (xs > outs ? xs : outs) * 2;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + 2 * g.land_bytes;
}

Geometry geometry(int n, int c_in, int c_out, int h, int w) {
  Geometry g;
  const int mt = ceil_div(c_out, 16);
  g.mw = mt == 1 ? 1 : 2;
  g.mz = ceil_div(mt, g.mw);
  g.ncw = ceil_div(w, WIN);
  g.wd = ceil_div(ceil_div(w, g.ncw), 8) * 8;
  g.cpr = g.wd / 8;
  g.groups = ceil_div(c_in, CG);
  g.wslots = g.groups < MAX_WSLOTS ? g.groups : MAX_WSLOTS;
  const int most = MAX_WARPS * ntw(g.mw) / g.cpr;  // >= 6
  g.rows = most < h ? most : h;
  // fewer rows a band (not below 2) until two blocks fit an SM and there
  // are tiles for about two blocks an SM
  for (;;) {
    layout(g);
    if (g.rows <= 2 || (g.smem <= SMEM_MOST &&
                        (long long)ceil_div(h, g.rows) * g.ncw * n * g.mz >= TARGET_BLOCKS))
      break;
    --g.rows;
  }
  g.bands = ceil_div(h, g.rows);
  g.total = g.bands * g.ncw * n;
  g.warps = ceil_div(g.rows * g.cpr, ntw(g.mw));
  // tiles a block walks: as many blocks as the SMs hold at once (by shared
  // memory, registers at the 128 a thread the kernel is built for, and
  // warps), all with `per` tiles but the last
  const int fits[] = {(228 * 1024) / (g.smem + 1024), 65536 / (32 * g.warps * 128),
                      64 / g.warps};
  int fit = 1;
  while (fit < fits[0] && fit < fits[1] && fit < fits[2]) ++fit;
  g.per = ceil_div(g.total, ceil_div(SMS * fit, g.mz));
  g.blocks = ceil_div(g.total, g.per);
  g.lsh_l = log2_lanes(g.lp);
  g.lsh_o = log2_lanes(g.cpr);
  g.cpr_mul = (65536 + g.cpr - 1) / g.cpr;  // exact for t < 65536 / cpr
  return g;
}

// Rows of (count) x (r2) walked by a lane group: row (c, r) = (k / r2, k %
// r2) for k = first, first + step, ...; one division to start, none after.
struct RowWalk {
  int c, r;
  __device__ __forceinline__ RowWalk(int first, int r2) : c(first / r2), r(first - c * r2) {}
  __device__ __forceinline__ void advance(int step, int r2) {
    r += step;
    while (r >= r2) {
      r -= r2;
      ++c;
    }
  }
};

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(p)));
}

// d += a . b; m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Land channels c0 .. c0+15 of rows y0-1 .. y0+rows, window columns x0-8 ..
// x0+wd+7, as 16-byte pieces: piece j of channel row (ch, r) at (ch*lpc +
// r*lp + j)*8, zero outside the image and past C_in.  A group of 2^lsh_l
// lanes lands row r, one piece a lane, for the 16 channels in turn.  Needs
// W % 8 == 0 and x 16-byte aligned, so a piece is in or out as a whole.
__device__ __forceinline__ void land_x(bf16* land, const bf16* xn, int c0, int c_in,
                                       int H, int W, long long L, int y0, int x0,
                                       const Geometry& g, int warp, int lane) {
  const int per = 32 >> g.lsh_l, j = lane & ((1 << g.lsh_l) - 1);
  const int gx = x0 - 8 + 8 * j;
  if (j >= g.lp) return;
  const bool col_in = gx >= 0 && gx < W;
  const int nch = min(CG, c_in - c0);
  for (int r = warp * per + (lane >> g.lsh_l); r < g.rows + 2; r += g.warps * per) {
    const int gy = y0 - 1 + r;
    const bool in = col_in && gy >= 0 && gy < H;
    const bf16* src = in ? xn + (long long)c0 * L + (long long)gy * W + gx : xn;
    bf16* dst = land + (r * g.lp + j) * 8;
#pragma unroll
    for (int ch = 0; ch < CG; ++ch) {
      const bool v = in && ch < nch;
      cp_async16(dst, v ? src : xn, v ? 16 : 0);
      src += in ? L : 0;
      dst += g.lpc * 8;
    }
  }
}

// The landing to xs: pixel (r, s), s = 0 .. wd+1 for window columns -1 ..
// wd, holds its 16 channels at (r*swp + s)*CP.  Warp w takes rows w,
// w + warps, ... and walks a row's pieces two at a time: one
// ldmatrix.x4.trans, whose 8-row matrices are 8 channels of a piece, gives
// lane (g, q) channels 2q, 2q+1 (and 8+2q, 9+2q) of pixel g of each piece:
// four 32-bit stores.  The 8 channel rows are lpc pieces apart (odd), so the
// loads hit 8 distinct bank groups; pixel g's words sit 12g + q words apart,
// 32 distinct banks.  Of the halo pieces (0 and lp-1) only window columns
// -1 and wd are kept.
__device__ __forceinline__ void transpose_x(bf16* xs, const bf16* land, const Geometry& g,
                                            int warp, int lane) {
  const int gq = lane >> 2, q = lane & 3, hi = lane >> 4;
  const auto keep = [&](int j) { return (j > 0 || gq == 7) && (j < g.lp - 1 || gq == 0); };
  for (int r = warp; r < g.rows + 2; r += g.warps) {
    const bf16* src = land + ((lane & 15) * g.lpc + r * g.lp + hi) * 8;
    bf16* dst = xs + (r * g.swp + gq - 7) * CP + 2 * q;  // piece j's pixel gq at column 8j + gq - 7
    for (int j = 0; j < g.lp; j += 2, src += 16, dst += 16 * CP) {
      const bool two = j + 1 < g.lp;
      uint32_t v[4];
      ldmatrix_x4_trans(v, two || !hi ? src : src - 8);  // no second piece: re-read the first
      if (keep(j)) {
        *reinterpret_cast<uint32_t*>(dst) = v[0];
        *reinterpret_cast<uint32_t*>(dst + 8) = v[1];
      }
      if (two && keep(j + 1)) {
        *reinterpret_cast<uint32_t*>(dst + 8 * CP) = v[2];
        *reinterpret_cast<uint32_t*>(dst + 8 * CP + 8) = v[3];
      }
    }
  }
}

// xs element by element, for rows that do not start 16-byte aligned.
__device__ __forceinline__ void stage_x_scalar(bf16* xs, const bf16* xn, int c0, int c_in,
                                               int H, int W, long long L, int y0, int x0,
                                               const Geometry& g, int tid, int nthr) {
  const int r2 = g.rows + 2, cols = g.wd + 2;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < CG * r2 * cols; e += nthr) {
    const int ch = e % CG, rs = e / CG;
    const int s = rs % cols, r = rs / cols;
    const int gy = y0 - 1 + r, gx = x0 - 1 + s;
    const bool in = c0 + ch < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
    xs[(r * g.swp + s) * CP + ch] = in ? xn[(long long)(c0 + ch) * L + (long long)gy * W + gx]
                                       : zero;
  }
}

// Wall slice of channels c0 .. c0+15 for output channels o0 .. o0+16*MW-1:
// row (t, o) at (t*16*MW + o)*CP, zero past C_in and C_out.  vec: C_in % 8
// == 0 and w_all 16-byte aligned, so each half row is one cp.async.
template <int MW>
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* w_all, int c0, int c_in,
                                        int c_out, int o0, bool vec, int tid, int nthr) {
  constexpr int OP = 16 * MW;
  const long long K = 9LL * c_in;
  if (vec) {
    for (int e = tid; e < 9 * OP * 2; e += nthr) {
      const int h = e & 1, to = e >> 1;
      const int o = to % OP, t = to / OP;
      const int ow = o0 + o, cc = c0 + 8 * h;
      const bool in = ow < c_out && cc < c_in;
      cp_async16(ws + (t * OP + o) * CP + 8 * h, in ? w_all + ow * K + t * c_in + cc : w_all,
                 in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < 9 * OP * CG; e += nthr) {
      const int ch = e % CG, to = e / CG;
      const int o = to % OP, t = to / OP;
      const int ow = o0 + o, cc = c0 + ch;
      ws[(t * OP + o) * CP + ch] = ow < c_out && cc < c_in ? w_all[ow * K + t * c_in + cc] : zero;
    }
  }
}

// Grid (blocks, mz); 32 * g.warps threads.  vec_x: W % 8 == 0 and x and
// out 16-byte aligned (cp.async staging, 16-byte stores); vec_w: the
// wall's rows are (see stage_w).
template <int MW>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
conv3x3_chw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_all,
                       bf16* __restrict__ out, int c_in, int c_out, int H, int W,
                       Geometry g, int vec_x, int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int OP = 16 * MW;
  constexpr int NTW = ntw(MW);
  constexpr int WSLICE = 9 * OP * CP;  // elements of one wall slice
  bf16* ws0 = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);

  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int o0 = blockIdx.y * OP;
  const int t_first = blockIdx.x * g.per;
  const int stages = (min(g.total, t_first + g.per) - t_first) * g.groups;
  const long long L = (long long)H * W;
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s & 1) * g.land_bytes);
  };
  // Stage s is channel group gi of tile t_first + s / groups, at image n,
  // output rows y0.., window columns x0..
  auto origin = [&](int s, int& n, int& y0, int& x0, int& gi) {
    const int k = s / g.groups, t = t_first + k, per_image = g.bands * g.ncw;
    gi = s - k * g.groups;
    n = t / per_image;
    const int b = t - n * per_image, band = b / g.ncw;
    y0 = band * g.rows;
    x0 = (b - band * g.ncw) * g.wd;
  };
  // Stage s's wall slice sits in slot gi while all slices fit (staged with
  // the block's first tile), else in slot s % MAX_WSLOTS (staged with every
  // stage).
  auto wslot = [&](int s, int gi) { return g.groups <= MAX_WSLOTS ? gi : s % MAX_WSLOTS; };
  // Stage s's pieces into landing buffer s & 1, and its wall slice where the
  // slot does not hold it yet: one commit group, empty past the last stage.
  auto issue = [&](int s) {
    if (s < stages) {
      int n, y0, x0, gi;
      origin(s, n, y0, x0, gi);
      if (vec_x)
        land_x(land_of(s), x + (long long)n * c_in * L, gi * CG, c_in, H, W, L, y0, x0, g,
               warp, lane);
      if (g.groups > MAX_WSLOTS || s < g.groups)
        stage_w<MW>(ws0 + wslot(s, gi) * WSLICE, w_all, gi * CG, c_in, c_out, o0, vec_w, tid,
                    nthr);
    }
    cp_async_commit();
  };

  const int a_lane = (lane & 15) * CP + (lane >> 4) * 8;
  float acc[MW][NTW][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // Slot j of this warp is n-tile t = j*warps + warp of a band: output row
  // t / cpr, columns 8*(t % cpr) .. +7.  Slots past the band's last row are
  // idle (their B lanes read slot 0's pixels).  boff[p]: the lane's ldmatrix
  // row of slot pair p at tap (0, 0).
  const auto row_of = [&](int t) { return (t * g.cpr_mul) >> 16; };
  int boff[NTW / 2];
#pragma unroll
  for (int p = 0; p < NTW / 2; ++p) {
    int t = (2 * p + (lane >> 4)) * g.warps + warp;
    if (t >= g.rows * g.cpr) t = 0;
    const int row = row_of(t);
    boff[p] = (row * g.swp + 8 * (t - row * g.cpr) + (lane & 7)) * CP + ((lane >> 3) & 1) * 8;
  }
  int nvalid = 0;

  issue(0);
  issue(1);
  for (int s = 0; s < stages; ++s) {
    int n, y0, x0, gi;
    origin(s, n, y0, x0, gi);
    cp_async_wait_prior();
    __syncthreads();  // stage s has landed; the block is done with xs
    if (vec_x)
      transpose_x(xs, land_of(s), g, warp, lane);
    else
      stage_x_scalar(xs, x + (long long)n * c_in * L, gi * CG, c_in, H, W, L, y0, x0, g, tid,
                     nthr);
    __syncthreads();  // xs holds stage s; its landing buffer is free
    issue(s + 2);

    if (gi == 0) {
      const int nslots = min(g.rows, H - y0) * g.cpr;
      nvalid = warp < nslots ? (nslots - warp + g.warps - 1) / g.warps : 0;
    }
    const bf16* wsg = ws0 + wslot(s, gi) * WSLICE + a_lane;
#pragma unroll
    for (int ki = 0; ki < 3; ++ki)
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        uint32_t a[MW][4];
#pragma unroll
        for (int m = 0; m < MW; ++m) ldmatrix_x4(a[m], wsg + ((3 * ki + kj) * OP + 16 * m) * CP);
        const bf16* xt = xs + (ki * g.swp + kj) * CP;
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          if (2 * p < nvalid) {
            uint32_t b[4];
            ldmatrix_x4(b, xt + boff[p]);
#pragma unroll
            for (int m = 0; m < MW; ++m) mma_acc(acc[m][2 * p], a[m], b[0], b[1]);
            if (2 * p + 1 < nvalid) {
#pragma unroll
              for (int m = 0; m < MW; ++m) mma_acc(acc[m][2 * p + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    if (gi + 1 < g.groups) continue;

    // The tile's last group: its outputs through xs, as 16*MW rows of
    // opitch, then out.  acc[m][j]: output channels 16m + gq (e < 2) and + 8
    // (e >= 2) of the block, the pixels 2q and 2q+1 of slot j's n-tile (the
    // m16n8 accumulator layout); 8 channel rows 4 words past a multiple of
    // 32 apart, so the stores hit 32 distinct banks.
    __syncthreads();  // the products are done with xs
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < nvalid) {
        const int t = j * g.warps + warp, row = row_of(t);
        const int pix = row * g.wd + 8 * (t - row * g.cpr) + 2 * q;
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162*>(xs + (16 * m + gq + 8 * hh) * g.opitch + pix) =
                __floats2bfloat162_rn(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
      }
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    __syncthreads();
    const int rb = min(g.rows, H - y0), ob = min(OP, c_out - o0);
    bf16* on = out + ((long long)n * c_out + o0) * L + (long long)y0 * W + x0;
    if (vec_x) {
      // a group of 2^lsh_o lanes stores one output row, 16 bytes a lane
      const int per = 32 >> g.lsh_o, c = lane & ((1 << g.lsh_o) - 1);
      if (c < g.cpr && x0 + 8 * c < W)
        for (RowWalk w(warp * per + (lane >> g.lsh_o), rb); w.c < ob; w.advance(g.warps * per, rb))
          *reinterpret_cast<uint4*>(on + w.c * L + (long long)w.r * W + 8 * c) =
              *reinterpret_cast<const uint4*>(xs + w.c * g.opitch + w.r * g.wd + 8 * c);
    } else {
      for (int e = tid; e < ob * rb * g.wd; e += nthr) {
        const int c = e % g.wd, orr = e / g.wd;
        const int r = orr % rb, o = orr / rb;
        if (x0 + c < W) on[o * L + (long long)r * W + c] = xs[o * g.opitch + r * g.wd + c];
      }
    }
  }
}

// Allows the kernel SMEM_MOST bytes of dynamic shared memory, once for each
// device (the attribute is kept per context).
template <int MW>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(conv3x3_chw_mma_kernel<MW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MOST);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int MW>
cudaError_t launch_mw(const bf16* x, const bf16* w_all, bf16* out, int c_in, int c_out,
                      int h, int w, const Geometry& g, int vec_x, int vec_w,
                      cudaStream_t stream) {
  const cudaError_t err = allow_smem<MW>();
  if (err != cudaSuccess) return err;
  conv3x3_chw_mma_kernel<MW><<<dim3(g.blocks, g.mz), 32 * g.warps, g.smem, stream>>>(
      x, w_all, out, c_in, c_out, h, w, g, vec_x, vec_w);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
                   int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, c_out, h, w);
  if (g.smem > SMEM_MOST) return cudaErrorInvalidConfiguration;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_x = w % 8 == 0 && aligned(x) && aligned(out);
  const int vec_w = c_in % 8 == 0 && aligned(w_all);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w_all);
  bf16* op = static_cast<bf16*>(out);
  if (g.mw == 1) return launch_mw<1>(xp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
  return launch_mw<2>(xp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// x: (n, c_in, h*w), w_all: (c_out, 9*c_in) tap-major, out: (n, c_out, h*w),
// all contiguous on the current device, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  bf16 with c_in > 8 runs on the tensor cores, the rest on
// the CUDA cores.  Returns a cudaError_t as int.
int conv3x3_chw(const void* x, const void* w_all, void* out, int n, int c_in,
                int c_out, int h, int w, int is_bf16, void* stream) {
  if (n < 1 || n > 65535 || c_in < 1 || c_out < 1 || c_out > MAX_COUT ||
      h < 1 || w < 1 || (h + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && c_in > tc::CC_MAX_CIN)
    err = tc::launch(x, w_all, out, n, c_in, c_out, h, w, s);
  else if (is_bf16)
    err = launch<__nv_bfloat16>(x, w_all, out, n, c_in, c_out, h, w, s);
  else
    err = launch<float>(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_chw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
