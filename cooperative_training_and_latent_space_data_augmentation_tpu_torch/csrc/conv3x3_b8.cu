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
// once to the input type at the store and dw returned in f32.  K6's input
// gradient is the forward on the flipped, transposed wall; with flip = 1
// the forward reads that wall out of the unflipped one,
// w'[i, t*C_out + o] = w_all[o, (8-t)*C_in + i], so no flipped copy is made.
//
// What bounds them on the H100: at the B8 bench's stages (16..64 channels,
// 192^2..48^2, batch 20) an output pixel carries 2*9*C_in*C_out operations
// on 2*(C_in + C_out) bytes, at most 288 operations a byte, under the
// card's 295 for bf16 on the tensor cores: the ideal kernel is bound by
// bytes (16->16 @ 192^2: 47.2 MB, 14.1 us).  On the CUDA cores in f32 the
// five stages' products alone take at least 0.2 ms (13.6 GFLOP at 67
// TFLOP/s).
//
// K6 in bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 out), out (C_out x pixels) = wall (C_out x 9*C_in) . P, with M =
// 16 output channels, N = 8 neighbouring pixels of one row (the TPU
// kernel's pixel block, which the gate keeps inside a row and 16-byte
// aligned) and a k-step = 16 input channels of one tap.  P' is never built:
//
//   * A tile is a band of whole rows of one column window (at most 8 pixel
//     blocks wide with one m-tile a warp, 6 with two; wider rows are cut
//     into windows of balanced widths).  A block owns every output channel
//     of its tiles and walks a run of them, each in stages of 16 input
//     channels, so x is read from device memory once for all nine taps and
//     all of C_out.  Its warps are m-groups x rows: warp (mg, r) owns row r
//     of the band, every pixel block of the window, and m-tiles 2*mg, 2*mg+1
//     (one m-tile a warp where C_out <= 16).  Bands are cut (with heights
//     differing by at most one row) until the grid holds about two blocks an
//     SM; the walk covers the rest.
//   * Staging: for each stage the band's rows with a one-row halo, and a
//     16-byte piece of halo on each side of the window, land by 16-byte
//     cp.async in CHW order (16 channel rows, odd pitch in pieces) two
//     stages ahead, into three landing buffers, with one barrier a stage.
//     Pieces outside the image and channels past C_in land as zeros
//     (source size 0), so the product loop has no masks.
//   * No transposing pass: the products read the landing buffer itself.  A
//     fragment register of B holds two neighbouring channels of one pixel,
//     which ldmatrix.x4.trans gives straight from the channel rows of two
//     pieces: the centre taps (kj = 1) of two pixel blocks.  A one-pixel tap
//     shift would break ldmatrix's 16-byte alignment, so the side taps are
//     the centre fragments moved one pixel across the lanes: lane (g, q)
//     takes pixel g - 1 from lane (g - 1, q), and pixel -1 from lane (7, q)
//     of the block on the left (kj = 2 alike, to the right), one shuffle a
//     register.  A warp loads each staged row's pieces once a kernel row
//     (its window plus the two halo pieces) and shifts them, instead of
//     nine loads of shifted copies.
//   * The wall stays in shared memory for the block's life, its slices of
//     16 input channels landed by cp.async with the first two stages: 9
//     taps x C_out rows of 32 bytes, the two 16-byte halves of a row
//     swapped on every fourth row, so the 8 rows an ldmatrix reads fall in 8
//     distinct bank groups without padding (at most 72 KB, at 64 -> 64).
//     flip = 1 lands rows of the unflipped wall, (8-t)*C_out + o for input
//     channel c0 + k, as rows k of 16 output channels in each m-tile's
//     block (swizzled alike) and takes A by ldmatrix.x4.trans: the flip is
//     in the addresses.
//   * Each lane's accumulator pair is two neighbouring pixels of one output
//     channel: it is stored straight from the registers as one bf16 pair,
//     four lanes to a pixel block.  One mma chain per output, no atomics:
//     two launches agree bit for bit.
//
// f32 stays on the CUDA cores in full f32 (no TF32: the port's f32 convs are
// full f32): a thread owns 8 consecutive output pixels of one row and 8
// output channels, 64 sums in registers, and for each input channel loads
// the 3 x 10 input window once and the channel's 9 x 8 weights from shared
// memory (flip = 1 stages them from the unflipped wall).
//
// K6dw in bf16 (tc::conv3x3_b8_dw_mma_kernel): an implicit GEMM on the
// tensor cores, dw^T (C_out x 9*C_in) = dy (C_out x pixels) . P^T, with the
// pixels as the reduction; P is never built.  It is K2's function on K2's
// layout (csrc/conv3x3_chw_dw.cu), landed as K6 lands x:
//
//   * A unit is a band of whole rows (heights differing by at most one) of
//     a column window of at most 24 pixel blocks, of one image; the host
//     picks band height and window width by the bytes the busiest block
//     lands.  A block owns 16 input channels (grid.y covers the rest),
//     every output channel and a run of consecutive units, about two blocks
//     an SM in all.  Each unit's x (its rows with a one-row halo, and a
//     16-byte halo piece on each side of the window) and dy (its rows)
//     land in CHW pieces by 16-byte cp.async two units ahead, into three
//     buffers, with one barrier a unit.  Pieces outside the image, and an
//     odd-width window's last dy piece, land as zeros (source size 0), so
//     the product loop has no masks.  One landed band serves all 9 taps and
//     every output channel.
//   * Warp (h, ki), 6 of them, owns kernel row ki and input channels 8h ..
//     8h+7: three n-tiles (kj = 0, 1, 2) by every 16-channel m-tile of
//     C_out.  A (dy) comes by ldmatrix.x4 straight from the staged rows, a
//     row an output channel and 8 pixels a 16-byte piece.  B (x): a 32-bit
//     register holds two neighbouring pixels of one input channel, so the
//     kj = 1 pair is an aligned word and the kj = 0 and 2 pairs, one bf16
//     off, are the halves of two aligned words by __byte_perm.  x's channel
//     pitch is odd in pieces, so the word loads of a warp hit 32 distinct
//     banks; dy's too, so the rows of an ldmatrix fall in distinct 16-byte
//     groups.
//   * Accuracy as in K2: each mma chain is at most two k-steps (one with
//     four m-tiles, C_out > 32, to fit 128 registers), and its result is
//     added to the warp's accumulators with an f32 add.
//   * The blocks run in thread-block clusters of 2: at the end each block
//     puts its sums in shared memory, and each block of a pair adds half of
//     them over the pair in rank order, through distributed shared memory,
//     into the pair's workspace slot (straight into dw where a launch has
//     one slot).
//
// K6dw in f32 (CUDA cores): a thread owns one input channel and 8 output
// channels over all 9 taps: 72 f32 sums.  For each pixel block it loads
// the channel's 3 x 10 window and takes the 8 x 8 dy values from a tile
// staged in shared memory, and does 576 FMAs; the fold over the window
// columns is implicit, since each tap's sum is kept apart.  Each block sums
// one slab of pixel blocks of one image into a workspace slot of its own.
//
// Both K6dw paths: Hopper's blocks run in no order, so the TPU kernel's
// sequential accumulation over images becomes two passes with a fixed
// summation order and no float atomics: conv3x3_b8_dw_reduce adds the
// workspace slots (RUNS interleaved runs of slots, then the runs' sums in
// turn).  The slots depend on the shapes only; two launches agree bit for
// bit.
//
// C interface (bound with ctypes): conv3x3_b8(...) and conv3x3_b8_dw(...)
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError() of the launches (0 on success);
// conv3x3_b8_dw_workspace(...) gives the workspace size in floats.  A
// bfloat16 x or dy must start on a 16-byte boundary.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int B = 8;        // output pixels a thread owns along a row
constexpr int OG = 8;       // output channels a thread owns
constexpr int MAX_C = 64;   // most channels on either side
constexpr int PB = 32;      // K6 f32: pixel blocks per block, one a lane
constexpr int CK = 16;      // K6 f32: input channels whose weights are staged at once
constexpr int TP = 8;       // K6dw f32: pixel blocks of dy staged at once
constexpr int DW_THREADS = 256;                // K6dw f32: most threads a block
constexpr long long DW_TARGET_THREADS = 65536;  // K6dw f32: about 16 warps an SM

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store8(float* p, const float (&v)[B]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The 3 x 10 window of channel plane xc around the pixel block (y, x0 .. x0+7):
// rows y-1 .. y+1, columns x0-1 .. x0+8, zero outside the image.
__device__ __forceinline__ void load_window(const float* xc, int y, int x0, int H, int W,
                                            float (&win)[3][B + 2]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int sy = y + r - 1;
    const bool row_ok = sy >= 0 && sy < H;
    const float* row = xc + (long long)sy * W;
#pragma unroll
    for (int c = 0; c < B + 2; ++c) {
      const int sx = x0 + c - 1;
      win[r][c] = (row_ok && sx >= 0 && sx < W) ? load_f32(row + sx) : 0.f;
    }
  }
}

// K6 in f32.  Grid (ceil(H*W/8 / PB), N), blockDim PB * ceil(C_out / OG).
// flip = 1: w_all is (C_in, 9*C_out), read flipped and transposed.
__global__ void __launch_bounds__(PB * MAX_C / OG)
conv3x3_b8_kernel(const float* __restrict__ x, const float* __restrict__ w_all,
                  float* __restrict__ out, int c_in, int c_out, int H, int W, int flip) {
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
  const float* xn = x + (long long)blockIdx.y * c_in * L;

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
      if (ci < ck && o < c_out)
        v = flip ? load_f32(w_all + (long long)(c0 + ci) * 9 * c_out + (8 - t) * c_out + o)
                 : load_f32(w_all + (long long)o * 9 * c_in + t * c_in + c0 + ci);
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
  float* on = out + (long long)blockIdx.y * c_out * L + (long long)y * W + x0;
#pragma unroll
  for (int o = 0; o < OG; ++o) {
    if (o0 + o >= c_out) break;
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = acc[j][o];
    store8(on + (long long)(o0 + o) * L, v);
  }
}

constexpr int RUNS = 16;  // K6dw: interleaved runs of slots in the reduce

// K6dw, pass 2, both paths.  out[e] = sum over the workspace slots p = 0 ..
// parts-1 of ws[p][e] in a fixed order: thread row j of a (32, RUNS) block
// adds slots j, j + RUNS, ... in turn, then row 0 adds the RUNS rows' sums
// in row order.
__global__ void __launch_bounds__(32 * RUNS)
conv3x3_b8_dw_reduce(const float* __restrict__ ws, float* __restrict__ out, int parts,
                     long long k) {
  __shared__ float part[RUNS][32];
  const long long e = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < k) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += RUNS) s += ws[(long long)p * k + e];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < k) {
    float total = part[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < RUNS; ++j) total += part[j][threadIdx.x];
    out[e] = total;
  }
}

cudaError_t launch_reduce(const float* ws, float* out, int parts, int c_in, int c_out,
                          cudaStream_t stream) {
  const long long k = 9LL * c_in * c_out;
  conv3x3_b8_dw_reduce<<<(unsigned)((k + 31) / 32), dim3(32, RUNS), 0, stream>>>(ws, out,
                                                                               parts, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 in bf16: tensor cores (see the note at the top).

namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int CG = 16;            // input channels a stage
constexpr int MAX_WARPS = 8;
constexpr int NLAND = 3;          // landing buffers: stages s+1 and s+2 land while s is read
constexpr int SMS = 132;          // SMs of an H100
constexpr int SLOTS = 2 * SMS;    // blocks the card holds at once by design
constexpr int SMEM_MOST = 113 * 1024;  // so that two blocks fit an SM
// pixel blocks (n-tiles) a warp owns along its row: 8 with one m-tile, 6
// with two (32 or 48 accumulators, so that the kernel fits 128 registers)
__host__ __device__ constexpr int ncmax(int mw) { return mw == 1 ? 8 : 6; }

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int log2_lanes(int per_row) {
  int k = 0;
  while (k < 5 && (1 << k) < per_row) ++k;
  return k;
}

// How the work is cut, and the shared memory of a block.  C_out is `mt`
// m-tiles of 16, `mw` a warp, in `mz` m-groups; the wall's slices hold `op`
// = 16*mw*mz rows.  An image row is w8 = W/8 pixel blocks in `ncw` windows
// of at most cpr; a window column is `nb` bands of at most `rows` rows; `tiles`
// = N * nb * ncw, walked in runs of `per` by `blocks` blocks of `warps` =
// mz * rows warps, each tile in `groups` stages.  Band b starts at row
// b*bq + min(b, br) and has bq rows, one more for b < br (bq = H / nb, br =
// H % nb); window k alike with wq = w8 / ncw and wr = w8 % ncw.  Landing buffer: 16
// channel rows of pitch `lpc` pieces (odd), each (rows + 2) staged rows of
// `lp` pieces, cpr + 2 rounded up to even (so a pair of pieces read by one
// ldmatrix never leaves its staged row); `lsh`: log2 of the lanes that
// land one staged row.
struct Geometry {
  int mw, mz, op, groups, ncw, nb, rows, tiles, per, blocks, warps;
  int bq, br, wq, wr, lp, lpc, lsh;
  int land_off, land_bytes, smem;  // bytes
};

// Returns false where the shapes overflow the kernel's int offsets.
bool geometry(int n, int c_in, int c_out, int h, int w, Geometry& g) {
  const int mt = ceil_div(c_out, 16);
  g.mw = mt == 1 ? 1 : 2;
  g.mz = ceil_div(mt, g.mw);
  g.op = 16 * g.mw * g.mz;
  g.groups = ceil_div(c_in, CG);
  const int w8 = w / 8;
  g.ncw = ceil_div(w8, ncmax(g.mw));
  const int cpr = ceil_div(w8, g.ncw);
  const int rmax = MAX_WARPS / g.mz;
  g.nb = ceil_div(h, rmax);
  const long long cols = (long long)n * g.ncw;
  // more, shorter bands (their heights differing by at most a row) while the
  // tiles would not fill the card's blocks
  if (cols * g.nb < SLOTS) {
    const long long more = SLOTS / cols;
    if (more > g.nb) g.nb = (int)(more < h ? more : h);
  }
  if (cols * g.nb > 0x7fffffffLL) return false;
  g.rows = ceil_div(h, g.nb);
  g.bq = h / g.nb;
  g.br = h % g.nb;
  g.wq = w8 / g.ncw;
  g.wr = w8 % g.ncw;
  g.warps = g.mz * g.rows;
  g.tiles = (int)(cols * g.nb);
  g.lp = (cpr + 3) & ~1;
  g.lpc = ((g.rows + 2) * g.lp) | 1;
  g.lsh = log2_lanes(g.lp);
  g.land_off = g.groups * 9 * g.op * 32;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + NLAND * g.land_bytes;
  // as many blocks as the SMs hold at once (by shared memory, registers at
  // the 128 a thread the kernel is built for, and warps), all with `per`
  // tiles but the last
  const int fits[] = {(228 * 1024) / (g.smem + 1024), 65536 / (32 * g.warps * 128),
                      64 / g.warps};
  int fit = 1;
  while (fit < fits[0] && fit < fits[1] && fit < fits[2]) ++fit;
  g.per = ceil_div(g.tiles, SMS * fit);
  g.blocks = ceil_div(g.tiles, g.per);
  return true;
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

// ldmatrix at a shared-memory byte address (32 bits: the product loop keeps
// its addresses in one register each)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// d += a . b; m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Wall slice element (o, k) of a tap (output channel o, input channel k),
// in elements from the tap's start; each m-tile of 16 output channels is a
// block of 256 elements.  flip = 0: row o of 16 input channels (A rows,
// ldmatrix); flip = 1: in each m-tile's block, row k of its 16 output
// channels (A columns, ldmatrix.trans).  Rows are 32 bytes, their two
// 16-byte halves swapped where bit 2 of the row is set, so the 8 rows an
// ldmatrix reads at one half fall in 8 distinct bank groups.
__device__ __forceinline__ int wall_at(int o, int k, bool flip) {
  if (!flip) return o * 16 + 8 * ((k >> 3) ^ ((o >> 2) & 1)) + (k & 7);
  return (o >> 4) * 256 + k * 16 + 8 * (((o >> 3) & 1) ^ ((k >> 2) & 1)) + (o & 7);
}

// Wall slice of input channels c0 .. c0+15 for output channels 0 .. op-1,
// tap t at t*op*16, zero past C_in and C_out:
//   flip = 0: A[o][k] = w_all[o*9*c_in + t*c_in + c0+k] (rows o: ldmatrix);
//   flip = 1: A[o][k] = w_all[(c0+k)*9*c_out + (8-t)*c_out + o] (w_all is
//             the forward's wall, (c_in, 9*c_out); rows k: ldmatrix.trans).
// vec: the 16-byte units of those rows are aligned (c_in, or c_out for
// flip, a multiple of 8, w_all 16-byte aligned), one cp.async each; else
// element by element.  Once a block, before the main loop.
template <bool FLIP>
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* w_all, int c0, int c_in,
                                        int c_out, int op, int vec, int tid, int nthr) {
  const int tap = op * 16;
  if (vec) {
    const int units = FLIP ? op >> 3 : 2;    // 16-byte units a row
    const int nrows = FLIP ? 16 : op;        // rows a tap
    for (int e = tid; e < 9 * nrows * units; e += nthr) {
      const int u = e % units, tr = e / units, row = tr % nrows, t = tr / nrows;
      const int o = FLIP ? 8 * u : row, k = FLIP ? row : 8 * u;
      const bool in = o < c_out && c0 + k < c_in;
      const bf16* src = FLIP ? w_all + ((long long)(c0 + k) * 9 + 8 - t) * c_out + o
                             : w_all + ((long long)o * 9 + t) * c_in + c0 + k;
      cp_async16(ws + t * tap + wall_at(o, k, FLIP), in ? src : w_all, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < 9 * op * CG; e += nthr) {
      const int k = e % CG, to = e / CG, o = to % op, t = to / op;
      bf16 v = zero;
      if (o < c_out && c0 + k < c_in)
        v = FLIP ? w_all[((long long)(c0 + k) * 9 + 8 - t) * c_out + o]
                 : w_all[((long long)o * 9 + t) * c_in + c0 + k];
      ws[t * tap + wall_at(o, k, FLIP)] = v;
    }
  }
}

// Land channels c0 .. c0+15 of rows y0-1 .. y0+hb, columns x0-8 .. x0+8*wk+7
// (the window's wk pixel blocks and a halo piece on each side), as 16-byte
// pieces: piece j of staged row r of channel ch at (ch*lpc + r*lp + j)*8,
// zero outside the image and past C_in.  A group of 2^lsh lanes lands a
// staged row, one piece a lane, for the 16 channels in turn.  W % 8 == 0
// and x 16-byte aligned, so a piece is in or out as a whole.
__device__ __forceinline__ void land_x(bf16* land, const bf16* xn, int c0, int c_in, int H,
                                       int W, int L, int y0, int hb, int x0, int wk,
                                       const Geometry& g, int warp, int lane) {
  const int per = 32 >> g.lsh, j = lane & ((1 << g.lsh) - 1);
  if (j >= wk + 2) return;
  const int gx = x0 - 8 + 8 * j;
  const bool col_in = gx >= 0 && gx < W;
  const int nch = min(CG, c_in - c0);
  for (int r = warp * per + (lane >> g.lsh); r < hb + 2; r += g.warps * per) {
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

// Grid (blocks); 32 * g.warps threads.  vec_w: see stage_w.
template <int MW, bool FLIP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
conv3x3_b8_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_all,
                      bf16* __restrict__ out, int c_in, int c_out, int H, int W, Geometry g,
                      int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = ncmax(MW);
  bf16* wall = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int mg = warp / g.rows, r = warp - mg * g.rows;  // m-group, row of the band
  const int gq = lane >> 2, q = lane & 3;
  const int t_first = blockIdx.x * g.per;
  const int stages = (min(g.tiles, t_first + g.per) - t_first) * g.groups;
  const int L = H * W;  // offsets inside one image fit 32 bits (valid())
  const int tap = g.op * 16;  // elements of one tap of a wall slice
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s % NLAND) * g.land_bytes);
  };
  // Stage s is channel group gi of tile t_first + s / groups: image n, band
  // rows y0 .. y0+hb-1, window columns x0 .. x0+8*wk-1.
  auto origin = [&](int s, int& n, int& y0, int& hb, int& x0, int& wk, int& gi) {
    const int k = s / g.groups, t = t_first + k, per_image = g.nb * g.ncw;
    gi = s - k * g.groups;
    n = t / per_image;
    const int b = t - n * per_image, band = b / g.ncw, win = b - band * g.ncw;
    y0 = band * g.bq + min(band, g.br);
    hb = g.bq + (band < g.br);
    x0 = 8 * (win * g.wq + min(win, g.wr));
    wk = g.wq + (win < g.wr);
  };
  // Stage s's pieces into landing buffer s % NLAND (none past the last
  // stage).
  auto land = [&](int s) {
    if (s < stages) {
      int n, y0, hb, x0, wk, gi;
      origin(s, n, y0, hb, x0, wk, gi);
      land_x(land_of(s), x + (long long)n * c_in * L, gi * CG, c_in, H, W, L, y0, hb, x0, wk,
             g, warp, lane);
    }
  };

  // Shared byte addresses of this lane's ldmatrix rows.  A (tap 0 of slice
  // 0), m-tile mg*MW (m-tile mg*MW + m is 512*m bytes on): ldmatrix.x4
  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k
  // 8-15); lane l gives row l & 7 of matrix l >> 3.  B (piece 0 of the band
  // row's staged row 0 in landing buffer 0): channel row (l & 7) + 8((l >>
  // 3) & 1) of piece l >> 4 of a pair, so b[0], b[1] are the first piece's
  // fragment, b[2], b[3] the second's.
  const uint32_t smem_s = smem_addr(smem);
  const int o0 = 16 * mg * MW;
  const int a_row = FLIP ? wall_at(o0 + 8 * ((lane >> 3) & 1), (lane & 7) + 8 * (lane >> 4), true)
                         : wall_at(o0 + (lane & 15), 8 * (lane >> 4), false);
  const uint32_t a_s = smem_s + 2 * a_row;
  const int b_row = ((lane & 7) + 8 * ((lane >> 3) & 1)) * g.lpc + r * g.lp + (lane >> 4);
  const uint32_t b_s = smem_s + g.land_off + 16 * b_row;
  const uint32_t tap2 = 2 * tap, row2 = 16 * g.lp;  // bytes of a tap's slice, a staged row

  float acc[MW][NC][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;

  // Commit groups: stage 0's pieces and the wall's first slice; stage 1's
  // pieces and the other slices (so the main loop stages no wall); then one
  // a stage, empty past the last.
  land(0);
  stage_w<FLIP>(wall, w_all, 0, c_in, c_out, g.op, vec_w, tid, nthr);
  cp_async_commit();
  land(1);
  for (int gi = 1; gi < g.groups; ++gi)
    stage_w<FLIP>(wall + gi * 9 * tap, w_all, gi * CG, c_in, c_out, g.op, vec_w, tid, nthr);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    int n, y0, hb, x0, wk, gi;
    origin(s, n, y0, hb, x0, wk, gi);
    cp_async_wait_prior();
    __syncthreads();  // stage s has landed; every warp is done with stage s-1
    land(s + 2);      // into stage s-1's landing buffer
    cp_async_commit();

    if (r < hb) {
      const uint32_t lrow = b_s + (s % NLAND) * g.land_bytes;
      const uint32_t wsl = gi * 9 * tap2;
#pragma unroll
      for (int ki = 0; ki < 3; ++ki) {
        // pieces 0 .. wk+1 of staged row r + ki: piece c + 1 is pixel block
        // c's centre tap, pieces c and c + 2 its neighbours
        uint32_t P[NC + 2][2];
        const uint32_t prow = lrow + ki * row2;
#pragma unroll
        for (int p = 0; p < (NC + 2) / 2; ++p) {
          if (2 * p < wk + 2) {
            uint32_t v[4];
            ldmatrix_x4_trans(v, prow + 32 * p);
            P[2 * p][0] = v[0];
            P[2 * p][1] = v[1];
            P[2 * p + 1][0] = v[2];
            P[2 * p + 1][1] = v[3];
          } else {
            P[2 * p][0] = P[2 * p][1] = P[2 * p + 1][0] = P[2 * p + 1][1] = 0u;
          }
        }
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) {
          const int t = 3 * ki + kj;
          uint32_t a[MW][4];
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            if (FLIP)
              ldmatrix_x4_trans(a[m], a_s + wsl + t * tap2 + 512 * m);
            else
              ldmatrix_x4(a[m], a_s + wsl + t * tap2 + 512 * m);
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (c < wk) {
              uint32_t b0 = P[c + 1][0], b1 = P[c + 1][1];
              if (kj == 0) {  // pixel g - 1: from lane g - 1, or lane 7 of block c - 1
                b0 = __shfl_sync(0xffffffffu, gq == 7 ? P[c][0] : b0, (lane + 28) & 31);
                b1 = __shfl_sync(0xffffffffu, gq == 7 ? P[c][1] : b1, (lane + 28) & 31);
              } else if (kj == 2) {  // pixel g + 1: from lane g + 1, or lane 0 of block c + 1
                b0 = __shfl_sync(0xffffffffu, gq == 0 ? P[c + 2][0] : b0, (lane + 4) & 31);
                b1 = __shfl_sync(0xffffffffu, gq == 0 ? P[c + 2][1] : b1, (lane + 4) & 31);
              }
#pragma unroll
              for (int m = 0; m < MW; ++m) mma_acc(acc[m][c], a[m], b0, b1);
            }
          }
        }
      }
    }
    if (gi + 1 < g.groups) continue;

    // The tile's last stage: acc[m][c] holds output channels 16(mg*MW + m)
    // + gq (e < 2) and + 8 (e >= 2), pixels 2q and 2q+1 of pixel block c
    // (the m16n8 accumulator layout), stored as bf16 pairs.
    if (r < hb) {
      bf16* on = out + (long long)n * c_out * L + (y0 + r) * W + x0 + 2 * q;
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 16 * (mg * MW + m) + gq + 8 * h;
          if (o < c_out) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
              if (c < wk)
                *reinterpret_cast<__nv_bfloat162*>(on + o * L + 8 * c) =
                    __floats2bfloat162_rn(acc[m][c][2 * h], acc[m][c][2 * h + 1]);
          }
        }
    }
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;
  }
}

// Allows `Kernel` SMEM_MOST bytes of dynamic shared memory, once for each
// device (the attribute is kept per context).
template <auto Kernel>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MOST);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int MW, bool FLIP>
cudaError_t launch_k(const bf16* x, const bf16* w_all, bf16* out, int c_in, int c_out, int h,
                     int w, const Geometry& g, int vec_w, cudaStream_t stream) {
  const cudaError_t err = allow_smem<conv3x3_b8_mma_kernel<MW, FLIP>>();
  if (err != cudaSuccess) return err;
  conv3x3_b8_mma_kernel<MW, FLIP><<<g.blocks, 32 * g.warps, g.smem, stream>>>(
      x, w_all, out, c_in, c_out, h, w, g, vec_w);
  return cudaGetLastError();
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
                   int h, int w, int flip, cudaStream_t stream) {
  Geometry g;
  if (!geometry(n, c_in, c_out, h, w, g) || g.smem > SMEM_MOST)
    return cudaErrorInvalidConfiguration;
  if (!aligned(x) || !aligned(out)) return cudaErrorInvalidValue;
  const int vec_w = (flip ? c_out : c_in) % 8 == 0 && aligned(w_all);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w_all);
  bf16* op = static_cast<bf16*>(out);
  if (g.mw == 1)
    return flip ? launch_k<1, true>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream)
                : launch_k<1, false>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream);
  return flip ? launch_k<2, true>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream)
              : launch_k<2, false>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream);
}

// ---------------------------------------------------------------------------
// K6dw in bf16: tensor cores (see the note at the top).

constexpr int DW_NWARP = 6;   // warp (h, ki) = (warp / 3, warp % 3)
constexpr int DW_NTH = 32 * DW_NWARP;
constexpr int DW_WMAX = 24;   // most pixel blocks in a window
constexpr int CLUSTER = 2;    // blocks of a cluster
constexpr int DW_ROW_COST = 64;  // dw_geometry: bytes a landed row costs beyond its own

__host__ __device__ constexpr int red_pitch(int mt) { return 16 * mt + 4; }  // floats a row
constexpr int red_bytes(int mt) { return 9 * CG * red_pitch(mt) * 4; }

// How a K6dw launch is cut.  C_out is `mt` m-tiles of 16 (1, 2 or 4).  An
// image row is w8 = W/8 pixel blocks in `ncw` windows, window k of wq + (k
// < wr) blocks from block k*wq + min(k, wr), at most `wdp` rounded up to
// even; the H rows are `nb` bands, band b of bq + (b < br) rows from row
// b*bq + min(b, br), at most `rows`.  A unit is (image, band, window),
// `units` in all, walked by `blocks` blocks (grid.x) for each of `groups`
// groups of 16 input channels (grid.y): block k takes uq units, one more
// for k < ur, from unit k*uq + min(k, ur).  Clusters of `cl` blocks along x
// share one of `slots` workspace slots.  A landing buffer, in 16-byte
// pieces: x as 16 channels of pitch `lpc` (odd), each r2 = rows + 2 staged
// rows of lp = wdp + 2 pieces (a halo piece each side), then dy as 16*mt
// channels of pitch `sd` (odd), each `rows` rows of `wdp` pieces; `stage`
// pieces in all.  Lanes 2^lsh_x land one staged x row, 2^lsh_d one dy row;
// a thread's landing rows advance by (dch, drr) channels and rows a step.
struct DwGeometry {
  int mt, groups, ncw, wq, wr, wdp, lp, nb, bq, br, rows, r2;
  int units, blocks, uq, ur, cl, slots;
  int lpc, sd, stage, lsh_x, lsh_d, dch_x, drr_x, dch_d, drr_d;
  int smem;  // bytes
};

// The cut whose busiest block lands the fewest bytes, plus DW_ROW_COST for
// each landed row (a separate run of device memory: on the H100, at equal
// bytes, wider windows land faster) and a share for each unit's set-up,
// over window widths of at most DW_WMAX blocks and band heights whose three
// buffers fit SMEM_MOST; the grid is about one wave of two blocks an SM.
// Shapes only, so the summation order is the same on every card.  units ==
// 0: no cut.
DwGeometry dw_geometry(int n, int c_in, int c_out, int h, int w) {
  const int w8 = w / 8;
  DwGeometry best{}, g{};
  long long best_cost = -1;
  g.mt = c_out <= 16 ? 1 : (c_out <= 32 ? 2 : 4);
  g.groups = ceil_div(c_in, CG);
  const int target = g.groups >= 2 * SMS ? 1 : 2 * SMS / g.groups;
  const int cgb = c_in < CG ? c_in : CG;
  for (int ncw = ceil_div(w8, DW_WMAX); ncw <= w8; ++ncw) {
    const int wd = ceil_div(w8, ncw);
    if (ceil_div(w8, wd) != ncw) continue;  // the same widest window as fewer windows
    g.ncw = ncw;
    g.wdp = wd + (wd & 1);
    g.lp = g.wdp + 2;
    for (int r = 1; r <= h; ++r) {
      g.nb = ceil_div(h, r);
      g.rows = ceil_div(h, g.nb);
      if (g.rows != r) continue;  // the same cut as a lower height
      g.r2 = g.rows + 2;
      g.lpc = (g.r2 * g.lp) | 1;
      g.sd = (g.rows * g.wdp) | 1;
      g.stage = CG * g.lpc + 16 * g.mt * g.sd;
      g.smem = NLAND * 16 * g.stage > red_bytes(g.mt) ? NLAND * 16 * g.stage : red_bytes(g.mt);
      if (g.smem > SMEM_MOST) break;
      const long long units = (long long)n * g.nb * ncw;
      if (units > 0x7fffffffLL) break;
      g.units = (int)units;
      g.blocks = g.units < target ? g.units : target;
      if (g.blocks >= CLUSTER) g.blocks -= g.blocks % CLUSTER;
      const long long cost =
          (long long)ceil_div(g.units, g.blocks) *
          (16LL * (cgb * g.r2 * g.lp + c_out * g.rows * g.wdp) +
           DW_ROW_COST * (cgb * g.r2 + c_out * g.rows) + 4096);
      if (best_cost < 0 || cost < best_cost) {
        best = g;
        best_cost = cost;
      }
    }
  }
  if (best_cost < 0) return DwGeometry{};
  g = best;
  g.wq = w8 / g.ncw;
  g.wr = w8 % g.ncw;
  g.bq = h / g.nb;
  g.br = h % g.nb;
  g.uq = g.units / g.blocks;
  g.ur = g.units % g.blocks;
  g.cl = g.blocks >= CLUSTER ? CLUSTER : 1;
  g.slots = g.blocks / g.cl;
  g.lsh_x = log2_lanes(g.lp);
  g.lsh_d = log2_lanes(g.wdp);
  const int step_x = DW_NWARP * (32 >> g.lsh_x), step_d = DW_NWARP * (32 >> g.lsh_d);
  g.dch_x = step_x / g.r2;
  g.drr_x = step_x % g.r2;
  g.dch_d = step_d / g.rows;
  g.drr_d = step_d % g.rows;
  return g;
}

// d = a . b; m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// B fragments of one k-step (16 pixels) for the three taps of a kernel
// row: b[kj][0] holds the lane's channel at pixels (2q+kj-1, 2q+kj) of the
// k-step, b[kj][1] at the same 8 on.  xp: the lane's staged x row at pixel
// 2q - 2 of the k-step (an even element: the left halo piece holds pixels
// -8 .. -1), so its words 0..2 hold pixels 2q-2 .. 2q+3 and words 4..6 the
// same 8 on.  kj = 1 is word 1; kj = 0 and 2 are the halves of words 0|1
// and 1|2.
__device__ __forceinline__ void dw_b_frags(uint32_t (&b)[3][2], const bf16* xp) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(xp);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t w0 = w[4 * half], w1 = w[4 * half + 1], w2 = w[4 * half + 2];
    b[0][half] = __byte_perm(w0, w1, 0x5432);
    b[1][half] = w1;
    b[2][half] = __byte_perm(w1, w2, 0x5432);
  }
}

// One chain of K k-steps (1 or 2) for every m-tile: fresh at the first
// k-step, added into acc with an f32 add after the last.  K-step k is at
// xp[k] (see dw_b_frags) and ap[k], the lane's ldmatrix row of m-tile 0 in
// the staged dy rows; m-tile m is 16*m channels (16*m*sd8 elements) on.
template <int MT, int K>
__device__ __forceinline__ void dw_chain(float (&acc)[MT][3][4], const bf16* const (&xp)[K],
                                         const bf16* const (&ap)[K], int sd8) {
  uint32_t b[K][3][2];
#pragma unroll
  for (int k = 0; k < K; ++k) dw_b_frags(b[k], xp[k]);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float t[3][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(ap[k] + m * 16 * sd8));
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        if (k == 0)
          mma_fresh(t[kj], a, b[k][kj][0], b[k][kj][1]);
        else
          mma_acc(t[kj], a, b[k][kj][0], b[k][kj][1]);
      }
    }
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] += t[kj][e];
  }
}

// The unit a block lands or multiplies: image, band, window.
struct Unit {
  int img, band, win;
};

__device__ __forceinline__ void advance(Unit& u, const DwGeometry& g) {
  if (++u.win == g.ncw) {
    u.win = 0;
    if (++u.band == g.nb) {
      u.band = 0;
      ++u.img;
    }
  }
}

// Grid (blocks, groups) in clusters of g.cl blocks along x, DW_NTH threads,
// at most 128 registers each (two blocks an SM).  Block (k, z) sums dw over
// its run of units for input channels 16z .. 16z+15 and every output
// channel; the blocks of a cluster add their sums into slot k / cl of ws,
// (9*c_in, c_out) floats a slot, row t*c_in + i.  x and dy are 16-byte
// aligned and W % 8 == 0: every piece lands by cp.async.
template <int MT>
__global__ void __maxnreg__(128)
conv3x3_b8_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                         float* __restrict__ ws, int c_in, int c_out, int H, int W,
                         DwGeometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const buf0 = reinterpret_cast<uint4*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = warp / 3, ki = warp - 3 * h;
  const int i0 = blockIdx.y * CG;
  const int cg = min(CG, c_in - i0);
  const bool active = 8 * h < cg;
  const int L = H * W;  // offsets inside one image fit 32 bits (valid())
  const int k = blockIdx.x;
  const int n_units = g.uq + (k < g.ur);

  Unit su, mu;  // the next unit to land, the next to multiply
  {
    const int u = k * g.uq + min(k, g.ur), per_image = g.nb * g.ncw;
    su.img = u / per_image;
    const int b = u - su.img * per_image;
    su.band = b / g.ncw;
    su.win = b - su.band * g.ncw;
    mu = su;
  }
  // This thread's landing: piece jx of x rows (channel, staged row) from
  // (ch_x0, rr_x0), piece jd of dy rows (channel, row) from (ch_d0, rr_d0),
  // each step (dch, drr) on.
  const int jx = lane & ((1 << g.lsh_x) - 1), jd = lane & ((1 << g.lsh_d) - 1);
  const int rx = warp * (32 >> g.lsh_x) + (lane >> g.lsh_x);
  const int rd = warp * (32 >> g.lsh_d) + (lane >> g.lsh_d);
  const int ch_x0 = rx / g.r2, rr_x0 = rx - ch_x0 * g.r2;
  const int ch_d0 = rd / g.rows, rr_d0 = rd - ch_d0 * g.rows;

  // Unit u into landing buffer s: x rows y0-1 .. y0+hb, pieces 0 .. wkp+1
  // (columns x0-8 .. x0+8*wkp+7), zero outside the image; dy rows y0 ..
  // y0+hb-1, pieces 0 .. wkp-1, zero past the window (an odd width's last
  // piece).  Nothing else of the buffer is read for this unit, but for
  // channels past the block's (c_in) or past c_out, which are never
  // landed: what the buffer holds there reaches only the sums of those
  // channels, and they are not stored.
  auto land = [&](const Unit& u, uint4* s) {
    const int y0 = u.band * g.bq + min(u.band, g.br), hb = g.bq + (u.band < g.br);
    const int wk = g.wq + (u.win < g.wr), wkp = wk + (wk & 1);
    const int x0 = 8 * (u.win * g.wq + min(u.win, g.wr));
    if (jx < wkp + 2) {
      const bf16* xn = x + ((long long)u.img * c_in + i0) * L;
      const int gx = x0 - 8 + 8 * jx;
      const bool col_in = gx >= 0 && gx < W;
      int ch = ch_x0, rr = rr_x0;
      while (ch < cg) {
        if (rr < hb + 2) {
          const int gy = y0 - 1 + rr;
          const bool in = col_in && gy >= 0 && gy < H;
          cp_async16(s + ch * g.lpc + rr * g.lp + jx, in ? xn + ch * L + gy * W + gx : x,
                     in ? 16 : 0);
        }
        rr += g.drr_x;
        ch += g.dch_x;
        if (rr >= g.r2) {
          rr -= g.r2;
          ++ch;
        }
      }
    }
    if (jd < wkp) {
      const bf16* dn = dy + (long long)u.img * c_out * L + y0 * W + x0 + 8 * jd;
      uint4* d = s + CG * g.lpc + jd;
      const bool in = jd < wk;
      int ch = ch_d0, rr = rr_d0;
      while (ch < c_out) {
        if (rr < hb)
          cp_async16(d + ch * g.sd + rr * g.wdp, in ? dn + ch * L + rr * W : dy, in ? 16 : 0);
        rr += g.drr_d;
        ch += g.dch_d;
        if (rr >= g.rows) {
          rr -= g.rows;
          ++ch;
        }
      }
    }
  };
  // Unit s of the run lands in buffer s % NLAND, one commit group each
  // (empty past the run); units s+1 and s+2 are in flight while s is
  // multiplied.
  auto land_ahead = [&](int s) {
    if (s < n_units) {
      land(su, buf0 + (s % NLAND) * g.stage);
      advance(su, g);
    }
    cp_async_commit();
  };

  // The lane's B row: channel 8h + gq, staged row ki, pixel 2q - 2 of the
  // window (element 8 + 2q - 2 of the row); its A row (ldmatrix.x4
  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k
  // 8-15)): dy channel lane & 15, piece lane >> 4.
  const int gq = lane >> 2, q = lane & 3;
  const int x_lane = ((8 * h + gq) * g.lpc + ki * g.lp) * 8 + 6 + 2 * q;
  const int a_lane = (CG * g.lpc + (lane & 15) * g.sd + (lane >> 4)) * 8;
  const int sd8 = 8 * g.sd;

  float acc[MT][3][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] = 0.f;

  land_ahead(0);
  land_ahead(1);
  for (int s = 0; s < n_units; ++s) {
    cp_async_wait_prior();
    __syncthreads();  // unit s has landed; every warp is done with unit s-1
    land_ahead(s + 2);  // into unit s-1's buffer
    if (active) {
      const int hb = g.bq + (mu.band < g.br);
      const int wk = g.wq + (mu.win < g.wr), cols = 8 * (wk + (wk & 1));
      const bf16* xs = reinterpret_cast<const bf16*>(buf0 + (s % NLAND) * g.stage);
      const bf16* xl = xs + x_lane;
      const bf16* al = xs + a_lane;
      // The unit's k-steps in row order, kpr a row: k-step j is pixels 16 *
      // (j % kpr) .. +15 of band row j / kpr (staged x row j / kpr + ki),
      // at offsets (xo, ao), taken in chains of CH (a chain may run on into
      // the next row).  Chains of two k-steps; of one with four m-tiles,
      // whose 48 accumulators leave no room for a second k-step's B in 128
      // registers.
      constexpr int CH = MT < 4 ? 2 : 1;
      const int kpr = cols / 16, nk = hb * kpr;
      const int x_wrap = 8 * g.lp - 16 * kpr, a_wrap = 8 * g.wdp - 16 * kpr;
      int xo = 0, ao = 0, cc = 0;
      auto next = [&]() {
        xo += 16;
        ao += 16;
        if (++cc == kpr) {
          cc = 0;
          xo += x_wrap;
          ao += a_wrap;
        }
      };
      int j = 0;
#pragma unroll 1
      for (; j + CH <= nk; j += CH) {
        const bf16* xp[CH];
        const bf16* ap[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          xp[c] = xl + xo;
          ap[c] = al + ao;
          next();
        }
        dw_chain<MT, CH>(acc, xp, ap, sd8);
      }
      if (j < nk) {
        const bf16* const xp[1] = {xl + xo};
        const bf16* const ap[1] = {al + ao};
        dw_chain<MT, 1>(acc, xp, ap, sd8);
      }
    }
    advance(mu, g);
  }

  // The block's sums into shared memory, rows (t, il) of pitch red_pitch:
  // acc[m][kj][e] is output channel 16m + gq (+8 for e >= 2), input channel
  // i0 + 8h + 2q + (e & 1), tap 3*ki + kj (the m16n8 accumulator layout).
  // Then block `rank` of the cluster adds rows [rank * part, (rank + 1) *
  // part) over the cluster's blocks in rank order, through distributed
  // shared memory, and stores them in the slot.
  cp_async_wait_all();  // the groups committed past the run are empty
  __syncthreads();
  constexpr int RP = red_pitch(MT);
  float* red = reinterpret_cast<float*>(smem);
  if (active)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kj = 0; kj < 3; ++kj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((3 * ki + kj) * CG + 8 * h + 2 * q + (e & 1)) * RP + 16 * m + gq + 8 * (e >> 1)] =
              acc[m][kj][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster holds its sums
  const int rank = (int)cluster.block_rank();
  const int part = 9 * CG / g.cl;
  float* slot = ws + (long long)(blockIdx.x / g.cl) * 9 * c_in * c_out;
  for (int e = tid; e < part * 4 * MT; e += DW_NTH) {
    const int row = rank * part + e / (4 * MT), col = 4 * (e % (4 * MT));
    const int t = row / CG, i = i0 + row % CG;
    if (i >= c_in || col >= c_out) continue;
    float4 v[CLUSTER];
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      if (b < g.cl)
        v[b] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, b) + row * RP + col);
    float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int b = 1; b < CLUSTER; ++b)
      if (b < g.cl) {
        sum[0] += v[b].x;
        sum[1] += v[b].y;
        sum[2] += v[b].z;
        sum[3] += v[b].w;
      }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < c_out) slot[((long long)t * c_in + i) * c_out + col + c] = sum[c];
  }
  cluster.sync();  // the other blocks have read this block's sums
}

template <int MT>
cudaError_t launch_dw_k(const bf16* x, const bf16* dy, float* ws, int c_in, int c_out, int h,
                        int w, const DwGeometry& g, cudaStream_t stream) {
  cudaError_t err = allow_smem<conv3x3_b8_dw_mma_kernel<MT>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks, g.groups);
  cfg.blockDim = dim3(DW_NTH);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = g.cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv3x3_b8_dw_mma_kernel<MT>, x, dy, ws, c_in, c_out, h, w, g);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

// Floats of workspace launch_dw needs (0 if no cut).
long long dw_workspace(int n, int c_in, int c_out, int h, int w) {
  return (long long)dw_geometry(n, c_in, c_out, h, w).slots * 9 * c_in * c_out;
}

cudaError_t launch_dw(const void* x, const void* dy, float* ws, float* out, int n, int c_in,
                      int c_out, int h, int w, cudaStream_t stream) {
  const DwGeometry g = dw_geometry(n, c_in, c_out, h, w);
  if (g.units < 1 || g.groups > 65535) return cudaErrorInvalidConfiguration;
  if (!aligned(x) || !aligned(dy)) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dp = static_cast<const bf16*>(dy);
  float* dst = g.slots > 1 ? ws : out;
  cudaError_t err;
  if (g.mt == 1)
    err = launch_dw_k<1>(xp, dp, dst, c_in, c_out, h, w, g, stream);
  else if (g.mt == 2)
    err = launch_dw_k<2>(xp, dp, dst, c_in, c_out, h, w, g, stream);
  else
    err = launch_dw_k<4>(xp, dp, dst, c_in, c_out, h, w, g, stream);
  if (err != cudaSuccess || g.slots == 1) return err;
  return launch_reduce(ws, out, g.slots, c_in, c_out, stream);
}

}  // namespace tc

// How K6dw in f32 cuts the work: input channels in groups of `cig` (one thread
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

// K6dw f32, pass 1.  Grid (parts, N, groups), blockDim ng * cig: thread tid owns
// input channel i0 + tid / ng and output channels OG * (tid % ng) .. +7 over
// the pixel blocks [spb * z, min(H*W/8, spb * (z+1))) of image n, and writes
// its 9 x 8 sums to workspace slot (n, z).
__global__ void __launch_bounds__(DW_THREADS)
conv3x3_b8_dw_partial(const float* __restrict__ x, const float* __restrict__ dy,
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
  const float* xc = x + ((long long)n * c_in + (i < c_in ? i : 0)) * L;
  const float* dn = dy + (long long)n * c_out * L;

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

cudaError_t launch_fwd_f32(const void* x, const void* w_all, void* out, int n, int c_in,
                           int c_out, int h, int w, int flip, cudaStream_t stream) {
  const long long nblocks = (long long)h * (w / B);
  const dim3 grid((unsigned)((nblocks + PB - 1) / PB), n);
  const int threads = PB * ((c_out + OG - 1) / OG);
  conv3x3_b8_kernel<<<grid, threads, 0, stream>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(w_all),
                                                  static_cast<float*>(out), c_in, c_out, h,
                                                  w, flip);
  return cudaGetLastError();
}

// K6dw in f32: the CUDA-core partial sums, then the slots' reduce.
cudaError_t launch_dw_f32(const void* x, const void* dy, float* ws, float* out, int n,
                          int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, c_out, h, w);
  const dim3 grid(g.parts, n, g.groups);
  conv3x3_b8_dw_partial<<<grid, g.ng * g.cig, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), ws, c_in, c_out, h, w, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(ws, out, n * g.parts, c_in, c_out, stream);
}

}  // namespace

extern "C" {

// x: (n, c_in, h*w); w_all: (c_out, 9*c_in) tap-major (flip = 0), or the
// forward's wall (c_in, 9*c_out) read flipped and transposed (flip = 1: the
// input gradient of that forward); out: (n, c_out, h*w); all contiguous on
// the current device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1; x
// and out 16-byte aligned).  Returns a cudaError_t as int.
int conv3x3_b8(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
               int h, int w, int flip, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? tc::launch(x, w_all, out, n, c_in, c_out, h, w, flip, s)
              : launch_fwd_f32(x, w_all, out, n, c_in, c_out, h, w, flip, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3_b8_dw needs for these shapes, in either dtype
// (0 if invalid): the more of the two routes' slots.
long long conv3x3_b8_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  const long long f32 = (long long)n * geometry(n, c_in, c_out, h, w).parts * 9 * c_in * c_out;
  const long long mma = tc::dw_workspace(n, c_in, c_out, h, w);
  return f32 > mma ? f32 : mma;
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
      is_bf16 ? tc::launch_dw(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch_dw_f32(x, dy, wsp, op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_b8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
