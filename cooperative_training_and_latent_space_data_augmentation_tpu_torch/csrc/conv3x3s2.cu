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
// no transpose to replace, so the kernels read and write NCHW directly and
// none splits the phases in device memory (K4's tensor-core kernel splits
// them in shared memory, in a pass it needs anyway).  They compute, with f32
// accumulation,
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
// 32->32 on 96^2) each moves a few MB and does 2*9*C_in*C_out operations
// per output pixel; on the tensor cores the bytes bound them (each of K4,
// K4dx and K4dw at batch 20: 29.5 MB, 8.8 us, and 14.7 MB, 4.4 us; the
// products take a tenth of that at 989 TFLOP/s).  Their bf16 paths run the
// products on the tensor cores; their f32 paths run them on the CUDA cores
// in f32 (67 TFLOP/s peak), so they are bound by operations there.
//
// What the designs do about it:
//
//   K4, bf16 (tc::conv3x3s2_mma_kernel): K1's implicit GEMM
//   (csrc/conv3x3_chw.cu) at stride 2, on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 out): out (C_out x output pixels) = wall (C_out
//   x 9*C_in) . P, with M = 16 output channels, N = 8 neighbouring output
//   pixels of one row and a k-step = 16 input channels of one tap; P is
//   never built.  A quarter of K1's products and output bytes on the same
//   x, so landing and transposing x is most of its work.
//
//   * A tile is a band of whole output rows (heights differing by at most
//     one, split on the host as q, rem) of a window of at most 64 output
//     columns (48 at W/2 = 48 and 96, so no window is half empty); its
//     input is the 2R+1 rows from input row 2*r0 - 1 and the 2*wd + 1
//     columns from 2*c0 - 1.  A block walks a run of tiles in stages of 16
//     input channels, for one or two m-tiles of C_out (grid.y covers the
//     rest), about two 8-warp blocks an SM.  The band height is the one
//     whose busiest block lands the fewest bytes (4 rows at 16->16 @ 192^2,
//     2 at 32->32 @ 96^2, batch 20).
//   * Staging by parity, the point of the design: x lands as raw CHW
//     16-byte pieces by cp.async, two stages ahead, and ldmatrix.x4.trans
//     turns 8 channel rows of a piece into each lane's channel pairs of one
//     pixel, as in K1.  Those stores go to two planes a row,
//     channel-innermost at a 48-byte pixel pitch: the even input columns
//     and the odd ones.  Output pixel c of a window reads tap kj = 1 at
//     even-plane pixel c, kj = 0 at odd-plane pixel c and kj = 2 at
//     odd-plane pixel c + 1 (odd-plane pixel j holds column 2*(c0 + j) - 1),
//     so the 8 pixels of an n-tile are 8 consecutive pixels of one plane
//     for every tap: each B fragment pair is one conflict-free ldmatrix.x4,
//     with no shuffles or masks.  Without the split the 8 pixels are 96
//     bytes apart and fall in 4 of the 8 16-byte bank groups, a 2-way
//     conflict whatever the pitch.  This is the TPU kernel's phase split
//     (chw_phase_split), done in shared memory by the transposing pass
//     rather than as a pass over device memory; the odd plane starts 3
//     pixels mod 8 after the even one, so the pass's stores hit 32 banks.
//   * The wall goes by cp.async to rows of one tap (A fragments by
//     ldmatrix.x4) and stays for the block's walk while C_in <= 64.  Edges
//     are data: the halo row above the image (an even H needs none below),
//     columns outside it, channels past C_in and wall rows past C_out are
//     zero in the staged copy (cp.async with a source size of 0).  Rows
//     that are not 16-byte aligned (W/2 % 8 != 0, or an operand off a
//     16-byte boundary) are staged and stored element by element.
//   * The sums go through shared memory and leave as 16-byte stores of
//     output rows.  One mma chain per output and no atomics: two launches
//     agree bit for bit.
//
//   K4, f32 (conv3x3s2_fwd_kernel): K1's CUDA-core design at stride 2: a
//   block owns one image and a TH x TW tile of output pixels, one thread
//   per pixel, all C_out (<= 64) sums in registers.  It stages CK input
//   channels of the (2TH+1) x (2TW+1) input window of its tile in shared
//   memory (zero outside the image), and the matching weights, so each
//   input pixel is read from device memory about once.  f32 stays off the
//   tensor cores because the port's f32 convs are full f32
//   (ops/conv_chw.py:full_f32) and the tensor cores' f32 input is TF32.
//   bf16 of any C_in takes the tensor-core kernel: below 16 channels its
//   one k-step a tap is part padding, but no K4 of the main path has so
//   few.
//
//   K4dx is a gather, not a scatter, so it needs no atomics.  The quad of
//   input pixels (2r+py, 2c+px) is reached by exactly the nine taps, from
//   the four dy values at (r, c), (r, c+1), (r+1, c) and (r+1, c+1): class
//   (py, px) = (0, 0) by tap (1,1) at (r, c); (0, 1) by (1,2) at (r, c) and
//   (1,0) at (r, c+1); (1, 0) by (2,1) at (r, c) and (0,1) at (r+1, c);
//   (1, 1) by (2,2), (2,0), (0,2) and (0,0) at (r, c), (r, c+1), (r+1, c)
//   and (r+1, c+1).  dx is 80 % of its bytes (23.6 of 29.5 MB at 16->16 on
//   192^2, batch 20), so the output path sets the pace.
//
//   K4dx, bf16 (tc::conv3x3s2_dx_mma_kernel): K4's tensor-core design
//   turned around, the stride now on the output side.  Four implicit GEMMs,
//   one a parity class: dx_class (C_in x dy pixels) = sum over the class's
//   taps of wall_t^T (C_in x C_out) . dy shifted by (dr, dc), with M = 16
//   input channels, N = 8 neighbouring dy columns of one row and a k-step =
//   16 output channels: nine products an (m-tile, n-tile, k-step), as in K4.
//
//   * A tile is a band of dy rows (split on the host as q, rem; the height
//     whose busiest block moves the fewest bytes) of a window of at most 64
//     dy columns (48 at W/2 = 48 and 96).  A block walks a run of tiles in
//     stages of 16 output channels, for one or two m-tiles of C_in (grid.y
//     covers the rest), about two 8-warp blocks an SM.  The halo runs
//     forward only: the dy row below the band and the column right of the
//     window (one extra landed piece, of which the first pixel is kept);
//     past the image they are zero, the mirror of K4's row and column -1.
//   * dy lands as raw CHW 16-byte pieces by cp.async, two stages ahead, and
//     ldmatrix.x4.trans turns 8 channel rows of a piece into each lane's
//     channel pairs of one pixel, stored channel-innermost at a 48-byte
//     pixel pitch (conflict-free loads and stores).  The shifts (dr, dc) are
//     then address offsets: each B fragment pair is one ldmatrix.x4, with
//     no shuffles or masks.  The wall's slices stay resident for the block's
//     walk (C_out <= 64), rows (tap, output channel) with 16 input channels
//     contiguous, which is A^T: ldmatrix.x4.trans gives A, reloaded for
//     each tap to fit 128 registers.
//   * The output straight from the accumulators: a warp holds all four
//     classes of its n-tiles, so lane (g, q) holds dx columns 4q .. 4q+3 of
//     the n-tile's 16 in both rows 2r and 2r+1 for channels g and g+8, one
//     8-byte store each; the four lanes of a group write one whole 32-byte
//     sector.  No shared memory on the way out.
//   * Edges are data: wall rows and dy channels past C_out (uninitialised
//     shared memory could hold NaN, and 0 * NaN is NaN) and the halo past
//     the image are zero in the staged copy; rows of an m-tile past C_in are
//     not stored.  Rows that are not 16-byte aligned (W/2 % 8 != 0, or dy,
//     dx or the wall off a 16-byte boundary) are staged and stored element
//     by element.  One mma chain per output, f32 sums over at most
//     9*C_out/16 k-steps rounded once, no atomics: two launches agree bit
//     for bit.
//
//   K4dx, f32 (conv3x3s2_dx_kernel): on the CUDA cores in full f32, as the
//   f32 paths of K4 and K4dw (the tensor cores' f32 input is TF32): a
//   thread owns one quad for 16 input channels, 64 sums; grid.z covers
//   images and groups of 16 input channels; the output channels are staged
//   CK at a time.
//
//   K4dw, bf16 (tc::conv3x3s2_dw_mma_kernel): an implicit GEMM on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 out), dw^T (C_out x
//   9*C_in) = dy (C_out x output pixels) . P^T, with the output pixels as
//   the reduction; P is never built.
//
//   * A unit is a band of whole output rows (heights differing by at most
//     one row, split on the host as q, rem) of a window of at most 96
//     output columns of one image.  A block owns 16 input channels (grid.y
//     covers the rest), every output channel and a run of consecutive
//     units; about two blocks an SM in all.  For each unit it stages the
//     2R+1 input rows of an R-row band, for all 9 taps at once, and the
//     band's dy rows, by 16-byte cp.async two stages deep: unit s+1 is in
//     flight while the warps multiply unit s.  A staged x row starts 8
//     elements left of input column 2*c0 (a zero piece at the image's left
//     edge gives column -1); a zero row gives row -1 above the image (an
//     even H needs none below); each dy row is padded to a multiple of 16
//     pixels with zeros, so no k-step crosses a row.  Rows that are not
//     16-byte aligned (W/2 % 8 != 0, or an operand that starts off a
//     16-byte boundary) are staged element by element into the same layout.
//   * Stride 2 without a relayout: word W[c] of a staged row holds the
//     bf16 pair (x[2c], x[2c+1]).  Output pixels p and p+1 (one B register)
//     read columns 2p+kj-1 and 2p+kj+1: the low halves of W[p] and W[p+1]
//     (kj = 1), their high halves (kj = 2), or the high halves of W[p-1] and
//     W[p] (kj = 0).  p is even, so two aligned 8-byte loads, (W[p-2],
//     W[p-1]) and (W[p], W[p+1]), and three __byte_perm give one B register
//     of all three taps of a kernel row.
//   * Warp (h, ki), 6 of them, owns kernel row ki and input channels
//     8h..8h+7: three n-tiles (kj = 0, 1, 2) by every 16-channel m-tile of
//     C_out.  A (dy) comes by ldmatrix.x4.  The x channel pitch is 16 mod 64
//     elements, so the 8-byte loads of each half-warp hit 32 distinct
//     banks; the dy pitch is an odd multiple of 8 elements, so the rows of
//     an ldmatrix fall in distinct 16-byte groups.
//   * Accuracy as in K2: each mma chain is at most two k-steps (one with
//     four m-tiles, C_out > 32, to fit 128 registers), and its result is
//     added to the warp's accumulators with an f32 add.
//   * The blocks run in thread-block clusters of 2: at the end each block
//     puts its sums in shared memory, and each block of a pair adds half
//     of them over the pair in rank order, through distributed shared
//     memory, into the pair's workspace slot (132 slots at 16->16 @ 192^2,
//     66 at 32->32 @ 96^2, batch 20; straight into dw where a launch has
//     one slot).
//
//   K4dw, f32: K2's CUDA-core design (csrc/conv3x3_chw_dw.cu) on the
//   stride-2 windows, full f32: a block owns one image, one run of output
//   sub-tiles ("chunk") and up to 16 input channels; a thread owns one
//   input channel and four output channels and keeps their 9 taps' 36 sums
//   in registers, and the block writes them to a workspace slot of its own,
//   (image, chunk).
//
//   Both K4dw paths: conv3x3s2_dw_reduce_kernel adds the workspace slots in
//   a fixed order (RUNS interleaved runs of slots, then the runs' sums in
//   turn), with many blocks.  No float atomics: two runs agree bit for bit,
//   and the partition depends on the shapes only, so the rounding is the
//   same on every card.
//
// C interface (bound with ctypes): each launcher runs on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError() of
// its launches (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_COUT = 64;

// ------------------------------------------------------------------ K4

constexpr int F_TW = 32;              // output tile width: one warp per tile row
constexpr int F_TH = 8;               // output tile height
constexpr int F_NT = F_TW * F_TH;     // threads per block
constexpr int F_CK = 4;               // input channels staged per pass
constexpr int F_SW = 2 * F_TW + 1;    // staged input window width
constexpr int F_SH = 2 * F_TH + 1;    // staged input window height

// K4, f32.  COB: C_out rounded up to the bucket the sums are kept for (16,
// 32 or 64).  Sums for o >= C_out see zero weights and are not stored.
template <int COB>
__global__ void __launch_bounds__(F_NT)
conv3x3s2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w_all,
                     float* __restrict__ out, int c_in, int c_out, int H, int W) {
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
  const float* xn = x + (long long)blockIdx.z * c_in * L;

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
        v = xn[(long long)(i0 + ci) * L + (long long)gy * W + gx];
      s_x[ci][a][b] = v;
    }
    for (int e = tid; e < F_CK * 9 * COB; e += F_NT) {
      const int ci = e / (9 * COB);
      const int t = (e / COB) % 9;
      const int o = e % COB;
      float v = 0.f;
      if (ci < ck && o < c_out)
        v = w_all[(long long)o * 9 * c_in + t * c_in + i0 + ci];
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
    float* on = out + (long long)blockIdx.z * c_out * L4 + (long long)r * W2 + c;
#pragma unroll
    for (int o = 0; o < COB; ++o)
      if (o < c_out) on[(long long)o * L4] = acc[o];
  }
}

// ---------------------------------------------------------------- K4dx

constexpr int D_TW = 32;              // quads per tile row: one warp
constexpr int D_TH = 8;               // quad rows per tile
constexpr int D_NT = D_TW * D_TH;     // threads per block
constexpr int D_CK = 16;              // output channels staged per pass
constexpr int D_CIG = 16;             // input channels per block; grid.z covers the rest

// K4dx, f32.
__global__ void __launch_bounds__(D_NT)
conv3x3s2_dx_kernel(const float* __restrict__ dy, const float* __restrict__ w_all,
                    float* __restrict__ dx, int c_in, int c_out, int H, int W,
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
  const float* dyn = dy + (long long)n * c_out * L4;

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
        v = dyn[(long long)(o0 + o) * L4 + (long long)r * W2 + c];
      s_dy[o][a][b] = v;
    }
    for (int e = tid; e < D_CK * 9 * D_CIG; e += D_NT) {
      const int o = e / (9 * D_CIG);
      const int t = (e / D_CIG) % 9;
      const int i = e % D_CIG;
      float v = 0.f;
      if (o < ck && i0 + i < c_in)
        v = w_all[(long long)(o0 + o) * 9 * c_in + t * c_in + i0 + i];
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
    float* dn = dx + (long long)n * c_in * L;
#pragma unroll
    for (int i = 0; i < D_CIG; ++i) {
      if (i0 + i >= c_in) break;
      float* di = dn + (long long)(i0 + i) * L;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        di[(long long)(2 * r + p / 2) * W + 2 * c + p % 2] = acc[p][i];
    }
  }
}

// ------------------------------------------------------- K4dw, f32 (CUDA cores)

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
template <int COB>
__global__ void __launch_bounds__(CI_T * COB / 4)
conv3x3s2_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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
  const float* xn = x + (long long)n * c_in * L;
  const float* dyn = dy + (long long)n * c_out * L4;
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
        v = xn[(long long)(i0 + ci) * L + (long long)gy * W + gx];
      s_x[ci * XS + a * sw + b] = v;
    }
    for (int e = tid; e < COB * th * tw; e += NT) {
      const int o = e / (th * tw);
      const int p = e % (th * tw);
      const int r = p / tw;
      const int c = p % tw;
      float v = 0.f;
      if (o < c_out && r < eh && c < ew)
        v = dyn[(long long)o * L4 + (long long)(r0 + r) * W2 + c0 + c];
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

constexpr int RUNS = 16;  // interleaved runs of slots in the reduce

// Pass 2 of both K4dw paths.  out[e] = sum over the workspace slots p = 0
// .. parts-1 of ws[p][e] in a fixed order: thread row j of a (32, RUNS)
// block adds slots j, j + RUNS, ... in turn, then row 0 adds the RUNS rows'
// sums in row order.
__global__ void __launch_bounds__(32 * RUNS)
conv3x3s2_dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int parts,
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
  conv3x3s2_dw_reduce_kernel<<<(unsigned)((k + 31) / 32), dim3(32, RUNS), 0, stream>>>(
      ws, out, parts, k);
  return cudaGetLastError();
}

// ------------------------------------------------------- K4dw, bf16 (mma)

namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int CG = 16;             // input channels a block; grid.y covers the rest
constexpr int NWARP = 6;           // warp (h, ki) = (warp / 3, warp % 3)
constexpr int NTH = 32 * NWARP;
constexpr int WD_MAX = 96;         // most output columns of a window
constexpr int XPAD = 8;            // staged x element j holds input column 2*c0 - XPAD + j
constexpr int SMS = 132;           // SMs of an H100
constexpr int SMEM_MOST = 113 * 1024;  // so that two blocks fit an SM
constexpr int CLUSTER = 2;         // blocks of a cluster (see the note at the top)

__host__ __device__ constexpr int red_pitch(int mt) { return 16 * mt + 4; }  // floats a row
constexpr int red_bytes(int mt) { return 9 * CG * red_pitch(mt) * 4; }

// How a launch is cut.  C_out is `mt` m-tiles of 16.  An output row is
// `ncw` windows of `wd` columns (a multiple of 16; the last may be
// shorter); the H/2 output rows of an image are `nb` bands, band b starting
// at row b*bq + min(b, br) with bq rows, one more for b < br, at most
// `rows`.  A unit is (image, band, window), `units` in all, walked in
// runs by `blocks` blocks (grid.x) for each of `groups` groups of 16 input
// channels (grid.y): block k takes uq units, one more for k < ur, from unit
// k*uq + min(k, ur).  Clusters of `cl` blocks along x share one of `slots`
// workspace slots.  A stage holds x as 16 channel rows of pitch `sx`, each
// r2 = 2*rows + 1 staged rows of `wx` = 2*wd + XPAD elements, then dy as
// 16*mt channels of pitch `sd`, each `rows` rows of `wd` pixels; `stage`
// elements in all.  Landing by cp.async: lanes 2^lsh_x land one x row (2^lsh_d
// one dy row); a thread's landing rows advance by (dch, drr) channels and
// rows a step.
struct Geometry {
  int mt, wd, wx, ncw, rows, nb, bq, br, r2;
  int units, blocks, uq, ur, cl, slots, groups;
  int sx, sd, stage, lsh_x, lsh_d, dch_x, drr_x, dch_d, drr_d;
  int smem;  // bytes
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int round_up(int a, int m) { return ceil_div(a, m) * m; }
// The smallest v >= a with v % m == r (0 <= r < m).
inline int round_up_to(int a, int m, int r) { return a + ((r - a % m) % m + m) % m; }
inline int log2_lanes(int per_row) {
  int s = 0;
  while (s < 5 && (1 << s) < per_row) ++s;
  return s;
}

// The band height whose busiest block stages the fewest bytes (plus a
// share for each unit's set-up), over heights whose two stages fit
// SMEM_MOST; the grid is about one wave of two blocks an SM.  Shapes only,
// so the summation order is the same on every card.  units == 0: no cut.
Geometry geometry(int n, int c_in, int c_out, int h, int w) {
  const int h2 = h / 2, w2 = w / 2;
  Geometry best{};
  long long best_cost = -1;
  Geometry g{};
  g.mt = c_out <= 16 ? 1 : (c_out <= 32 ? 2 : 4);
  g.ncw = ceil_div(w2, WD_MAX);
  g.wd = round_up(ceil_div(w2, g.ncw), 16);
  g.wx = 2 * g.wd + XPAD;
  g.groups = ceil_div(c_in, CG);
  const int target = g.groups >= 2 * SMS ? 1 : 2 * SMS / g.groups;
  const int cg_bytes = 2 * (c_in < CG ? c_in : CG);
  for (int r = 1; r <= h2; ++r) {
    g.nb = ceil_div(h2, r);
    g.rows = ceil_div(h2, g.nb);
    if (g.rows != r) continue;  // the same cut as a lower height
    g.r2 = 2 * g.rows + 1;
    g.sx = round_up_to(g.r2 * g.wx, 64, 16);
    g.sd = round_up_to(g.rows * g.wd, 16, 8);
    g.stage = CG * g.sx + 16 * g.mt * g.sd;
    g.smem = 2 * 2 * g.stage > red_bytes(g.mt) ? 2 * 2 * g.stage : red_bytes(g.mt);
    if (g.smem > SMEM_MOST) break;
    const long long units = (long long)n * g.nb * g.ncw;
    if (units > 0x7fffffffLL) break;
    g.units = (int)units;
    g.blocks = g.units < target ? g.units : target;
    if (g.blocks >= CLUSTER) g.blocks -= g.blocks % CLUSTER;
    const long long cost = (long long)ceil_div(g.units, g.blocks) *
                           ((long long)cg_bytes * g.r2 * g.wx + 2LL * c_out * g.rows * g.wd + 4096);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  if (best_cost < 0) return Geometry{};
  g = best;
  g.bq = h2 / g.nb;
  g.br = h2 % g.nb;
  g.uq = g.units / g.blocks;
  g.ur = g.units % g.blocks;
  g.cl = g.blocks >= CLUSTER ? CLUSTER : 1;
  g.slots = g.blocks / g.cl;
  g.lsh_x = log2_lanes(g.wx / 8);
  g.lsh_d = log2_lanes(g.wd / 8);
  const int step_x = NWARP * (32 >> g.lsh_x), step_d = NWARP * (32 >> g.lsh_d);
  g.dch_x = step_x / g.r2;
  g.drr_x = step_x % g.r2;
  g.dch_d = step_d / g.rows;
  g.drr_d = step_d % g.rows;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(p)));
}

// d = a . b (fresh) or d += a . b; m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of one k-step (16 output pixels) for the three taps of a
// kernel row: b[kj][0] holds output pixels (2q, 2q+1) of the k-step, b[kj][1]
// pixels (2q+8, 2q+9).  xp: the lane's staged channel row at word W[p], p
// the k-step's first pixel + 2q (even), so xp - 4 .. xp + 3 hold W[p-2] ..
// W[p+1] and xp + 12 .. xp + 19 the same 8 pixels on.
__device__ __forceinline__ void b_frags(uint32_t (&b)[3][2], const bf16* xp) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint2 lo = *reinterpret_cast<const uint2*>(xp + 16 * half - 4);  // W[p-2], W[p-1]
    const uint2 hi = *reinterpret_cast<const uint2*>(xp + 16 * half);      // W[p], W[p+1]
    b[0][half] = __byte_perm(lo.y, hi.x, 0x7632);  // columns 2p-1, 2p+1
    b[1][half] = __byte_perm(hi.x, hi.y, 0x5410);  // columns 2p, 2p+2
    b[2][half] = __byte_perm(hi.x, hi.y, 0x7632);  // columns 2p+1, 2p+3
  }
}

// One or two k-steps (TWO) at one position of a band row, for every
// m-tile: the chain is fresh at the first k-step and added into acc with
// an f32 add after the last.  ap: the lane's ldmatrix row of m-tile 0.
template <int MT, bool TWO>
__device__ __forceinline__ void k_steps(float (&acc)[MT][3][4], const bf16* xp, const bf16* ap,
                                        int sd) {
  uint32_t b0[3][2], b1[3][2];
  b_frags(b0, xp);
  if (TWO) b_frags(b1, xp + 32);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float t[3][4];
    uint32_t a[4];
    ldmatrix_x4(a, ap + m * 16 * sd);
#pragma unroll
    for (int kj = 0; kj < 3; ++kj) mma_fresh(t[kj], a, b0[kj][0], b0[kj][1]);
    if (TWO) {
      ldmatrix_x4(a, ap + m * 16 * sd + 16);
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) mma_acc(t[kj], a, b1[kj][0], b1[kj][1]);
    }
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] += t[kj][e];
  }
}

// The unit a block stages or multiplies: image, band, window.
struct Unit {
  int img, band, win;
};

__device__ __forceinline__ void advance(Unit& u, const Geometry& g) {
  if (++u.win == g.ncw) {
    u.win = 0;
    if (++u.band == g.nb) {
      u.band = 0;
      ++u.img;
    }
  }
}

// Grid (blocks, groups) in clusters of g.cl blocks along x, NTH threads, at
// most 128 registers each (two blocks an SM).  Block (k, z) sums dw over
// its run of units for input channels 16z .. 16z+15 and every output
// channel; the blocks of a cluster add their sums into slot k / cl of ws,
// (9*c_in, c_out) floats a slot, row t*c_in + i.  vec: x and dy land by
// cp.async (W/2 % 8 == 0, both 16-byte aligned); else element by element.
template <int MT>
__global__ void __maxnreg__(128)
conv3x3s2_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        float* __restrict__ ws, int c_in, int c_out, int H, int W, Geometry g,
                        int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stage0 = reinterpret_cast<bf16*>(smem);

  // Channels past the block's or past C_out are never staged: zero both
  // stages once.
  for (int e = threadIdx.x; e < g.stage / 4; e += NTH)  // 2 stages * 2 B / 16 B
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp / 3, ki = warp - 3 * h;
  const int i0 = blockIdx.y * CG;
  const int cg = min(CG, c_in - i0);
  const bool active = 8 * h < cg;
  const int H2 = H / 2, W2 = W / 2;
  const long long L = (long long)H * W, L4 = (long long)H2 * W2;
  const int k = blockIdx.x;
  const int n_units = g.uq + (k < g.ur);
  Unit su, mu;  // the next unit to stage, the next to multiply
  {
    const int u = k * g.uq + min(k, g.ur);
    const int per_image = g.nb * g.ncw;
    su.img = u / per_image;
    const int b = u - su.img * per_image;
    su.band = b / g.ncw;
    su.win = b - su.band * g.ncw;
    mu = su;
  }
  // This thread's first landing rows: x (channel, staged row), dy
  // (channel, row); each step moves them by (dch, drr).
  const int rx = warp * (32 >> g.lsh_x) + (lane >> g.lsh_x);
  const int rd = warp * (32 >> g.lsh_d) + (lane >> g.lsh_d);
  const int ch_x0 = rx / g.r2, rr_x0 = rx - ch_x0 * g.r2;
  const int ch_d0 = rd / g.rows, rr_d0 = rd - ch_d0 * g.rows;

  // Stage unit u into stage buffer xs (x, then dy at xs + CG*sx): every
  // element of the block's channels is written, with the image's values or
  // zero.
  auto stage = [&](const Unit& u, bf16* xs) {
    bf16* ds = xs + CG * g.sx;
    const int y0 = u.band * g.bq + min(u.band, g.br);
    const int rb = g.bq + (u.band < g.br);  // output rows of the band
    const int xr = 2 * rb + 1;              // input rows they read
    const int c0 = u.win * g.wd;
    const int gy0 = 2 * y0 - 1, gx0 = 2 * c0 - XPAD;
    const bf16* xn = x + ((long long)u.img * c_in + i0) * L;
    const bf16* dn = dy + (long long)u.img * c_out * L4;
    if (vec) {
      {
        const int step = 1 << g.lsh_x, cpr = g.wx / 8, j0 = lane & (step - 1);
        int ch = ch_x0, rr = rr_x0;
        while (ch < cg) {
          const int gy = gy0 + rr;
          const bool row_in = rr < xr && gy >= 0 && gy < H;
          const bf16* src = xn + ch * L + (long long)gy * W;
          bf16* dst = xs + ch * g.sx + rr * g.wx;
          for (int j = j0; j < cpr; j += step) {
            const int gc = gx0 + 8 * j;
            const bool in = row_in && gc >= 0 && gc < W;
            cp_async16(dst + 8 * j, in ? src + gc : x, in ? 16 : 0);
          }
          rr += g.drr_x;
          ch += g.dch_x;
          if (rr >= g.r2) {
            rr -= g.r2;
            ++ch;
          }
        }
      }
      {
        const int step = 1 << g.lsh_d, cpr = g.wd / 8, j0 = lane & (step - 1);
        int ch = ch_d0, rr = rr_d0;
        while (ch < c_out) {
          const bf16* src = dn + ch * L4 + (long long)(y0 + rr) * W2;
          bf16* dst = ds + ch * g.sd + rr * g.wd;
          for (int j = j0; j < cpr; j += step) {
            const int gc = c0 + 8 * j;
            const bool in = rr < rb && gc < W2;
            cp_async16(dst + 8 * j, in ? src + gc : dy, in ? 16 : 0);
          }
          rr += g.drr_d;
          ch += g.dch_d;
          if (rr >= g.rows) {
            rr -= g.rows;
            ++ch;
          }
        }
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int ch = 0; ch < cg; ++ch)
        for (int rr = warp; rr < g.r2; rr += NWARP) {
          const int gy = gy0 + rr;
          const bool row_in = rr < xr && gy >= 0 && gy < H;
          const bf16* src = xn + ch * L + (long long)gy * W;
          bf16* dst = xs + ch * g.sx + rr * g.wx;
          for (int j = lane; j < g.wx; j += 32) {
            const int gc = gx0 + j;
            dst[j] = row_in && gc >= 0 && gc < W ? src[gc] : zero;
          }
        }
      for (int ch = 0; ch < c_out; ++ch)
        for (int rr = warp; rr < g.rows; rr += NWARP) {
          const bf16* src = dn + ch * L4 + (long long)(y0 + rr) * W2;
          bf16* dst = ds + ch * g.sd + rr * g.wd;
          for (int j = lane; j < g.wd; j += 32) {
            const int gc = c0 + j;
            dst[j] = rr < rb && gc < W2 ? src[gc] : zero;
          }
        }
    }
  };

  const int gq = lane >> 2, q = lane & 3;
  const int x_lane = (8 * h + gq) * g.sx + ki * g.wx + XPAD + 4 * q;
  const int a_lane = (lane & 15) * g.sd + (lane >> 4) * 8;

  float acc[MT][3][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][kj][e] = 0.f;

  // Unit s of the run goes to stage s & 1, one commit group each (empty
  // past the run); unit s + 1 is in flight while unit s is multiplied.
  auto stage_ahead = [&](int s) {
    if (s < n_units) {
      stage(su, stage0 + (s & 1) * g.stage);
      advance(su, g);
    }
    cp_async_commit();
  };
  stage_ahead(0);
  for (int s = 0; s < n_units; ++s) {
    stage_ahead(s + 1);     // into the stage unit s - 1 left
    cp_async_wait_prior();  // unit s has landed
    __syncthreads();
    if (active) {
      const int rb = g.bq + (mu.band < g.br);
      const int c0 = mu.win * g.wd;
      const int cols = min(g.wd, (W2 - c0 + 15) / 16 * 16);
      const bf16* xs = stage0 + (s & 1) * g.stage;
      const bf16* xl = xs + x_lane;
      const bf16* al = xs + CG * g.sx + a_lane;
      for (int r = 0; r < rb; ++r) {
        const bf16* xr = xl + 2 * r * g.wx;  // staged rows 2r + ki
        const bf16* ar = al + r * g.wd;
        // chains of two k-steps; of one with four m-tiles, whose 48
        // accumulators leave no room for a second k-step's B in 128 registers
        int c = 0;
        if (MT < 4)
          for (; c + 32 <= cols; c += 32) k_steps<MT, true>(acc, xr + 2 * c, ar + c, g.sd);
        for (; c < cols; c += 16) k_steps<MT, false>(acc, xr + 2 * c, ar + c, g.sd);
      }
    }
    advance(mu, g);
    __syncthreads();  // this stage is free for unit s + 2
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
  for (int e = threadIdx.x; e < part * 4 * MT; e += NTH) {
    const int row = rank * part + e / (4 * MT), col = 4 * (e % (4 * MT));
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
    const int t = row / CG, i = i0 + row % CG;
    if (i < c_in)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < c_out) slot[((long long)t * c_in + i) * c_out + col + c] = sum[c];
  }
  cluster.sync();  // the other blocks have read this block's sums
}

// Allows KERNEL SMEM_MOST bytes of dynamic shared memory, once for each
// device (the attribute is kept per context).
template <auto KERNEL>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MOST);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int MT>
cudaError_t launch_partial(const bf16* x, const bf16* dy, float* ws, int c_in, int c_out, int h,
                           int w, const Geometry& g, int vec, cudaStream_t stream) {
  cudaError_t err = allow_smem<conv3x3s2_dw_mma_kernel<MT>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks, g.groups);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = g.cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv3x3s2_dw_mma_kernel<MT>, x, dy, ws, c_in, c_out, h, w, g,
                           vec);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch(const void* x, const void* dy, float* ws, float* out, int n, int c_in,
                   int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, c_out, h, w);
  if (g.units < 1 || g.groups > 65535) return cudaErrorInvalidConfiguration;
  const int vec = (w / 2) % 8 == 0 && aligned(x) && aligned(dy);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dp = static_cast<const bf16*>(dy);
  float* dst = g.slots > 1 ? ws : out;
  cudaError_t err;
  if (g.mt == 1)
    err = launch_partial<1>(xp, dp, dst, c_in, c_out, h, w, g, vec, stream);
  else if (g.mt == 2)
    err = launch_partial<2>(xp, dp, dst, c_in, c_out, h, w, g, vec, stream);
  else
    err = launch_partial<4>(xp, dp, dst, c_in, c_out, h, w, g, vec, stream);
  if (err != cudaSuccess || g.slots == 1) return err;
  return launch_reduce(ws, out, g.slots, c_in, c_out, stream);
}

// --------------------------------------------------------- K4, bf16 (mma)

constexpr int CP = 24;              // staged channels a pixel: CG + 8 of padding (48 bytes)
constexpr int F_WARPS = 8;          // warps a block
constexpr int F_NTH = 32 * F_WARPS;
constexpr int F_NTW = 4;            // most n-tiles a warp owns in a band: two ldmatrix pairs
constexpr int F_WIN = 64;           // most output columns of a window
constexpr int F_MAX_WSLOTS = 4;     // wall slices kept; C_in <= 64 keeps all of them
constexpr int F_STAGE_COST = 4096;  // a stage's set-up in the band-height model, as landed bytes

// How K4's tensor-core kernel cuts a launch, and a block's shared memory.
// A tile is a band of output rows of a window of `wd` output columns (`cpr`
// n-tiles of 8): `ncw` windows across an output row; the H/2 output rows
// are `nb` bands, band b starting at row b*bq + min(b, br) with bq rows, one
// more for b < br, at most `rows`; `total` tiles over the batch, in (image,
// band, window) order.  Block k along grid.x walks tiles k*per .. +per-1,
// each in `groups` stages of 16 input channels; along grid.y (`mz` blocks)
// it owns `mw` m-tiles of 16 output channels.  Shared memory holds:
//   * the wall: `wslots` slices of 9 taps x 16*mw rows x CP;
//   * xs, the parity planes of r2 = 2*rows + 1 input rows (input row 2*y0 -
//     1 + r at row r), `rowp` pixels x CP a row: the even plane at pixel j
//     (input column 2*x0 + 2j, j < wd), the odd plane at pixel opl + j
//     (column 2*x0 + 2j - 1, j <= wd); at a tile's end, its outputs, 16*mw
//     rows of `opitch` elements;
//   * two landing buffers: 16 channel rows (pitch `lpc` pieces) of r2 rows
//     of `lp` 16-byte pieces, input columns 2*x0 - 8 .. 2*x0 + 2*wd - 1.
// lsh_l, lsh_o: log2 of the lanes that land one row of pieces (lp) or store
// one output row (cpr pieces); cpr_mul: t / cpr = (t * cpr_mul) >> 16 for
// the band's n-tiles t.
struct FwdGeometry {
  int mw, mz, wd, cpr, ncw, rows, nb, bq, br, r2, total, per, blocks, groups, wslots;
  int opl, rowp, opitch, lp, lpc, lsh_l, lsh_o, cpr_mul;
  int xs_off, land_off, land_bytes, smem;  // bytes
};

void fwd_layout(FwdGeometry& g) {
  g.r2 = 2 * g.rows + 1;
  g.opl = g.wd + 3;  // 3 mod 8: see transpose_s2
  g.rowp = g.opl + g.wd + 1;
  g.opitch = ceil_div(g.rows * g.wd, 64) * 64 + 8;  // 4 words past a multiple of 32
  g.lp = g.wd / 4 + 1;
  g.lpc = (g.r2 * g.lp) | 1;  // odd: see transpose_s2
  g.xs_off = g.wslots * 9 * 16 * g.mw * CP * 2;
  const int xs = g.r2 * g.rowp * CP, outs = 16 * g.mw * g.opitch;
  g.land_off = g.xs_off + (xs > outs ? xs : outs) * 2;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + 2 * g.land_bytes;
}

// The band height whose busiest block lands the fewest bytes (plus a share
// for each stage's set-up), over heights whose shared memory lets two
// blocks fit an SM and whose n-tiles the warps hold; the grid is about two
// blocks an SM.  total == 0: no cut.
FwdGeometry fwd_geometry(int n, int c_in, int c_out, int h, int w) {
  const int h2 = h / 2, w2 = w / 2;
  FwdGeometry g{};
  const int mt = ceil_div(c_out, 16);
  g.mw = mt == 1 ? 1 : 2;
  g.mz = ceil_div(mt, g.mw);
  g.ncw = ceil_div(w2, F_WIN);
  g.wd = round_up(ceil_div(w2, g.ncw), 8);
  g.cpr = g.wd / 8;
  g.groups = ceil_div(c_in, CG);
  g.wslots = g.groups < F_MAX_WSLOTS ? g.groups : F_MAX_WSLOTS;
  const int target = 2 * SMS / g.mz;
  FwdGeometry best{};
  long long best_cost = -1;
  for (int r = 1; r <= h2 && r * g.cpr <= F_WARPS * F_NTW; ++r) {
    g.nb = ceil_div(h2, r);
    g.rows = ceil_div(h2, g.nb);
    if (g.rows != r) continue;  // the same cut as a lower height
    fwd_layout(g);
    if (g.smem > SMEM_MOST) break;
    const long long total = (long long)n * g.nb * g.ncw;
    if (total > 0x7fffffffLL) continue;
    g.total = (int)total;
    g.per = ceil_div(g.total, target);
    const long long cost =
        (long long)g.per * g.groups * ((long long)CG * g.r2 * g.lp * 16 + F_STAGE_COST);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  if (best_cost < 0) return FwdGeometry{};
  g = best;
  g.bq = h2 / g.nb;
  g.br = h2 % g.nb;
  g.blocks = ceil_div(g.total, g.per);
  g.lsh_l = log2_lanes(g.lp);
  g.lsh_o = log2_lanes(g.cpr);
  g.cpr_mul = (65536 + g.cpr - 1) / g.cpr;  // exact for t < 65536 / cpr
  return g;
}

// Stage s of a block whose run starts at tile t_first, for K4's and K4dx's
// cuts (FwdGeometry, DxGeometry): group gi of the stage's tile, the tile's
// image n, its band's first row y0 and rb rows, its window's first column x0.
template <class Geo>
__device__ __forceinline__ void stage_origin(const Geo& g, int t_first, int s, int& n, int& y0,
                                             int& rb, int& x0, int& gi) {
  const int k = s / g.groups, t = t_first + k, per_image = g.nb * g.ncw;
  gi = s - k * g.groups;
  n = t / per_image;
  const int b = t - n * per_image, band = b / g.ncw;
  y0 = band * g.bq + min(band, g.br);
  rb = g.bq + (band < g.br);
  x0 = (b - band * g.ncw) * g.wd;
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

// Land channels c0 .. c0+15 of input rows gy0 .. gy0+xr-1, columns gx0 ..
// gx0 + 8*lp - 1, as 16-byte pieces: piece j of channel row (ch, r) at
// (ch*lpc + r*lp + j)*8, zero outside the image and past C_in.  A group of
// 2^lsh_l lanes lands row r, one piece a lane, for the 16 channels in turn.
// Needs W % 8 == 0 and x 16-byte aligned, so a piece is in or out as a
// whole (gx0 is a multiple of 8).
__device__ __forceinline__ void land_s2(bf16* land, const bf16* xn, int c0, int c_in, int H,
                                        int W, long long L, int gy0, int gx0, int xr,
                                        const FwdGeometry& g, int warp, int lane) {
  const int per = 32 >> g.lsh_l, j = lane & ((1 << g.lsh_l) - 1);
  const int gx = gx0 + 8 * j;
  if (j >= g.lp) return;
  const bool col_in = gx >= 0 && gx < W;
  const int nch = min(CG, c_in - c0);
  for (int r = warp * per + (lane >> g.lsh_l); r < xr; r += F_WARPS * per) {
    const int gy = gy0 + r;
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

// The landing to the parity planes.  Pixel d of a landed row (input column
// 2*x0 + d, d = -8 .. 2*wd - 1; piece j holds d = 8j - 8 .. 8j - 1) goes to
// the even plane at d / 2 (d even, d >= 0) or to the odd plane at (d + 1) /
// 2 (d odd, d >= -1): of the halo piece (j = 0) only d = -1 is kept.  Warp
// w takes rows w, w + 8, ... and walks a row's pieces two at a time: one
// ldmatrix.x4.trans, whose 8-row matrices are 8 channels of a piece, gives
// lane (g, q) channels 2q, 2q+1 (and 8+2q, 9+2q) of pixel g of each piece,
// four 32-bit stores.  The 8 channel rows are lpc pieces apart (odd), so
// the loads hit 8 distinct bank groups.  A piece's 8 pixels go to 4
// consecutive pixels of each plane, 12 words a pixel, at words 12p + q of
// the even plane, {0-7, 12-15, 24-27} + 16j mod 32, and 12(opl + p) + q of
// the odd one, opl = 3 mod 8 putting them 4 words on, {8-11, 16-23, 28-31}
// + 16j mod 32: a store hits 32 distinct banks.
__device__ __forceinline__ void transpose_s2(bf16* xs, const bf16* land, const FwdGeometry& g,
                                             int xr, int warp, int lane) {
  const int gq = lane >> 2, q = lane & 3, hi = lane >> 4;
  // the plane pixel of pixel gq of piece 0 (4 on for each piece after it)
  const int pix0 = (gq & 1) ? g.opl + (gq + 1) / 2 - 4 : gq / 2 - 4;
  for (int r = warp; r < xr; r += F_WARPS) {
    const bf16* src = land + ((lane & 15) * g.lpc + r * g.lp + hi) * 8;
    bf16* dst = xs + (r * g.rowp + pix0) * CP + 2 * q;
    for (int j = 0; j < g.lp; j += 2, src += 16, dst += 8 * CP) {
      const bool two = j + 1 < g.lp;
      uint32_t v[4];
      ldmatrix_x4_trans(v, two || !hi ? src : src - 8);  // no second piece: re-read the first
      if (j > 0 || gq == 7) {
        *reinterpret_cast<uint32_t*>(dst) = v[0];
        *reinterpret_cast<uint32_t*>(dst + 8) = v[1];
      }
      if (two) {
        *reinterpret_cast<uint32_t*>(dst + 4 * CP) = v[2];
        *reinterpret_cast<uint32_t*>(dst + 4 * CP + 8) = v[3];
      }
    }
  }
}

// The planes element by element, for rows that are not 16-byte aligned:
// input column 2*x0 - 1 + s goes to the odd plane at s / 2 (s even) or to
// the even plane at (s - 1) / 2 (s odd).
__device__ __forceinline__ void stage_s2_scalar(bf16* xs, const bf16* xn, int c0, int c_in,
                                                int H, int W, long long L, int gy0, int x0,
                                                int xr, const FwdGeometry& g, int tid) {
  const int cols = 2 * g.wd + 1;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < CG * xr * cols; e += F_NTH) {
    const int ch = e % CG, rs = e / CG;
    const int s = rs % cols, r = rs / cols;
    const int gy = gy0 + r, gx = 2 * x0 - 1 + s;
    const bool in = c0 + ch < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int pix = (s & 1) ? (s - 1) / 2 : g.opl + s / 2;
    xs[(r * g.rowp + pix) * CP + ch] =
        in ? xn[(long long)(c0 + ch) * L + (long long)gy * W + gx] : zero;
  }
}

// Wall slice of channels c0 .. c0+15 for output channels o0 .. o0+16*MW-1:
// row (t, o) at (t*16*MW + o)*CP, zero past C_in and C_out.  vec: C_in % 8
// == 0 and w_all 16-byte aligned, so each half row is one cp.async.
template <int MW>
__device__ __forceinline__ void stage_wall(bf16* wsl, const bf16* w_all, int c0, int c_in,
                                           int c_out, int o0, bool vec, int tid) {
  constexpr int OP = 16 * MW;
  const long long K = 9LL * c_in;
  if (vec) {
    for (int e = tid; e < 9 * OP * 2; e += F_NTH) {
      const int h = e & 1, to = e >> 1;
      const int o = to % OP, t = to / OP;
      const int ow = o0 + o, cc = c0 + 8 * h;
      const bool in = ow < c_out && cc < c_in;
      cp_async16(wsl + (t * OP + o) * CP + 8 * h, in ? w_all + ow * K + t * c_in + cc : w_all,
                 in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < 9 * OP * CG; e += F_NTH) {
      const int ch = e % CG, to = e / CG;
      const int o = to % OP, t = to / OP;
      const int ow = o0 + o, cc = c0 + ch;
      wsl[(t * OP + o) * CP + ch] =
          ow < c_out && cc < c_in ? w_all[ow * K + t * c_in + cc] : zero;
    }
  }
}

// Grid (blocks, mz), F_NTH threads, at most 128 registers each (two blocks
// an SM).  vec_x: W/2 % 8 == 0 and x and out 16-byte aligned (cp.async
// landing, 16-byte stores); vec_w: the wall's rows are (see stage_wall).
template <int MW>
__global__ void __launch_bounds__(F_NTH, 2)
conv3x3s2_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_all,
                     bf16* __restrict__ out, int c_in, int c_out, int H, int W, FwdGeometry g,
                     int vec_x, int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int OP = 16 * MW;
  constexpr int WSLICE = 9 * OP * CP;  // elements of one wall slice
  bf16* ws0 = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H2 = H / 2, W2 = W / 2;
  const int o0 = blockIdx.y * OP;
  const int t_first = blockIdx.x * g.per;
  const int stages = (min(g.total, t_first + g.per) - t_first) * g.groups;
  const long long L = (long long)H * W, L4 = (long long)H2 * W2;
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s & 1) * g.land_bytes);
  };
  // Stage s is channel group gi of tile t_first + s / groups: image n,
  // output rows y0 .. y0+rb-1, window columns x0 ..
  auto origin = [&](int s, int& n, int& y0, int& rb, int& x0, int& gi) {
    stage_origin(g, t_first, s, n, y0, rb, x0, gi);
  };
  // Stage s's wall slice sits in slot gi while all slices fit (staged with
  // the block's first tile), else in slot s % F_MAX_WSLOTS (staged with
  // every stage).
  auto wslot = [&](int s, int gi) { return g.groups <= F_MAX_WSLOTS ? gi : s % F_MAX_WSLOTS; };
  // Stage s's pieces into landing buffer s & 1 (the 2*rb + 1 input rows its
  // band reads), and its wall slice where the slot does not hold it yet:
  // one commit group, empty past the last stage.
  auto prefetch = [&](int s) {
    if (s < stages) {
      int n, y0, rb, x0, gi;
      origin(s, n, y0, rb, x0, gi);
      if (vec_x)
        land_s2(land_of(s), x + (long long)n * c_in * L, gi * CG, c_in, H, W, L, 2 * y0 - 1,
                2 * x0 - 8, 2 * rb + 1, g, warp, lane);
      if (g.groups > F_MAX_WSLOTS || s < g.groups)
        stage_wall<MW>(ws0 + wslot(s, gi) * WSLICE, w_all, gi * CG, c_in, c_out, o0, vec_w,
                       tid);
    }
    cp_async_commit();
  };

  const int a_lane = (lane & 15) * CP + (lane >> 4) * 8;
  float acc[MW][F_NTW][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < F_NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // Slot j of this warp is n-tile t = j*F_WARPS + warp of a band: output
  // row t / cpr, columns 8*(t % cpr) .. +7.  Slots past the band's last row
  // are idle (their B lanes read slot 0's pixels).  boff[p]: the lane's
  // ldmatrix row of slot pair p at tap (0, 1), the even plane of staged row
  // 2 * (output row).
  const auto row_of = [&](int t) { return (t * g.cpr_mul) >> 16; };
  int boff[F_NTW / 2];
#pragma unroll
  for (int p = 0; p < F_NTW / 2; ++p) {
    int t = (2 * p + (lane >> 4)) * F_WARPS + warp;
    if (t >= g.rows * g.cpr) t = 0;
    const int row = row_of(t);
    boff[p] = (2 * row * g.rowp + 8 * (t - row * g.cpr) + (lane & 7)) * CP +
              ((lane >> 3) & 1) * 8;
  }
  int nvalid = 0;

  prefetch(0);
  prefetch(1);
  for (int s = 0; s < stages; ++s) {
    int n, y0, rb, x0, gi;
    origin(s, n, y0, rb, x0, gi);
    cp_async_wait_prior();
    __syncthreads();  // stage s has landed; the block is done with xs
    if (vec_x)
      transpose_s2(xs, land_of(s), g, 2 * rb + 1, warp, lane);
    else
      stage_s2_scalar(xs, x + (long long)n * c_in * L, gi * CG, c_in, H, W, L, 2 * y0 - 1, x0,
                      2 * rb + 1, g, tid);
    __syncthreads();  // xs holds stage s; its landing buffer is free
    prefetch(s + 2);

    if (gi == 0) {
      const int nslots = rb * g.cpr;
      nvalid = warp < nslots ? (nslots - warp + F_WARPS - 1) / F_WARPS : 0;
    }
    // tap (ki, kj) of output column c reads staged row 2r + ki at input
    // column 2c + kj - 1: the even plane at c (kj = 1), the odd plane at c
    // (kj = 0) or at c + 1 (kj = 2)
    const bf16* wsg = ws0 + wslot(s, gi) * WSLICE + a_lane;
#pragma unroll
    for (int ki = 0; ki < 3; ++ki)
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        uint32_t a[MW][4];
#pragma unroll
        for (int m = 0; m < MW; ++m) ldmatrix_x4(a[m], wsg + ((3 * ki + kj) * OP + 16 * m) * CP);
        const bf16* xt = xs + (ki * g.rowp + (kj == 1 ? 0 : g.opl + (kj >> 1))) * CP;
#pragma unroll
        for (int p = 0; p < F_NTW / 2; ++p) {
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
    for (int j = 0; j < F_NTW; ++j) {
      if (j < nvalid) {
        const int t = j * F_WARPS + warp, row = row_of(t);
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
    const int ob = min(OP, c_out - o0);
    bf16* on = out + ((long long)n * c_out + o0) * L4 + (long long)y0 * W2 + x0;
    if (vec_x) {
      // a group of 2^lsh_o lanes stores one output row, 16 bytes a lane
      const int per = 32 >> g.lsh_o, c = lane & ((1 << g.lsh_o) - 1);
      if (c < g.cpr && x0 + 8 * c < W2)
        for (RowWalk w(warp * per + (lane >> g.lsh_o), rb); w.c < ob;
             w.advance(F_WARPS * per, rb))
          *reinterpret_cast<uint4*>(on + w.c * L4 + (long long)w.r * W2 + 8 * c) =
              *reinterpret_cast<const uint4*>(xs + w.c * g.opitch + w.r * g.wd + 8 * c);
    } else {
      for (int e = tid; e < ob * rb * g.wd; e += F_NTH) {
        const int c = e % g.wd, orr = e / g.wd;
        const int r = orr % rb, o = orr / rb;
        if (x0 + c < W2) on[o * L4 + (long long)r * W2 + c] = xs[o * g.opitch + r * g.wd + c];
      }
    }
  }
}

template <int MW>
cudaError_t launch_fwd_mw(const bf16* x, const bf16* w_all, bf16* out, int c_in, int c_out,
                          int h, int w, const FwdGeometry& g, int vec_x, int vec_w,
                          cudaStream_t stream) {
  const cudaError_t err = allow_smem<conv3x3s2_mma_kernel<MW>>();
  if (err != cudaSuccess) return err;
  conv3x3s2_mma_kernel<MW><<<dim3(g.blocks, g.mz), F_NTH, g.smem, stream>>>(
      x, w_all, out, c_in, c_out, h, w, g, vec_x, vec_w);
  return cudaGetLastError();
}

// K4, bf16.
cudaError_t launch_fwd_mma(const void* x, const void* w_all, void* out, int n, int c_in,
                           int c_out, int h, int w, cudaStream_t stream) {
  const FwdGeometry g = fwd_geometry(n, c_in, c_out, h, w);
  if (g.total < 1 || g.smem > SMEM_MOST) return cudaErrorInvalidConfiguration;
  const int vec_x = (w / 2) % 8 == 0 && aligned(x) && aligned(out);
  const int vec_w = c_in % 8 == 0 && aligned(w_all);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w_all);
  bf16* op = static_cast<bf16*>(out);
  if (g.mw == 1) return launch_fwd_mw<1>(xp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
  return launch_fwd_mw<2>(xp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
}

// -------------------------------------------------------- K4dx, bf16 (mma)

constexpr int D_NTW = 4;      // n-tile slots a warp holds with one m-tile (two with two)
constexpr int WSL = 9 * 16 * CP;  // elements of one wall slice: 9 taps x 16 output channels

// How K4dx's tensor-core kernel cuts a launch, and a block's shared memory.
// A tile is a band of dy rows of a window of `wd` dy columns (`cpr` n-tiles
// of 8): `ncw` windows across a dy row; the H/2 dy rows are `nb` bands, band
// b starting at row b*bq + min(b, br) with bq rows, one more for b < br, at
// most `rows`; `total` tiles over the batch, in (image, band, window) order.
// Block k along grid.x walks tiles k*per .. +per-1, each in `groups` stages
// of 16 output channels; along grid.y (`mz` blocks) it owns `mw` m-tiles of
// 16 input channels.  Shared memory holds:
//   * the wall: mw x groups slices (input channels i0 + 16m .., output
//     channels 16*gi ..) of 9 taps x 16 rows x CP, slice m*groups + gi;
//   * xs, the stage's dy channel-innermost: rows + 1 rows (dy row y0 + r at
//     row r) of `rowp` pixels x CP, pixel p holding dy column x0 + p, p = 0
//     .. wd (the last is the halo column);
//   * two landing buffers: 16 channel rows (pitch `lpc` pieces) of rows + 1
//     rows of `lp` = cpr + 1 16-byte pieces, dy columns x0 .. x0 + wd + 7.
// npair: the landed pieces of a row taken two at a time; lsh_l: log2 of the
// lanes that land one channel row; cpr_mul: t / cpr = (t * cpr_mul) >> 16.
struct DxGeometry {
  int mw, mz, wd, cpr, ncw, rows, nb, bq, br, total, per, blocks, groups;
  int rowp, lp, lpc, npair, lsh_l, cpr_mul;
  int xs_off, land_off, land_bytes, smem;  // bytes
};

void dx_layout(DxGeometry& g) {
  const int r2 = g.rows + 1;
  g.rowp = g.wd + 1;
  g.lp = g.cpr + 1;
  g.lpc = (r2 * g.lp) | 1;  // odd: see transpose_dx
  g.npair = ceil_div(g.lp, 2);
  g.xs_off = g.mw * g.groups * WSL * 2;
  g.land_off = g.xs_off + r2 * g.rowp * CP * 2;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + 2 * g.land_bytes;
}

// The band height whose busiest block moves the fewest bytes (its landed dy,
// plus a share for each stage's set-up, and its dx), over heights whose
// n-tiles the warps hold and whose shared memory lets two blocks fit an SM;
// the grid is about two blocks an SM.  total == 0: no cut.
DxGeometry dx_geometry(int n, int c_in, int c_out, int h, int w) {
  const int h2 = h / 2, w2 = w / 2;
  DxGeometry g{};
  const int mt = ceil_div(c_in, 16);
  g.mw = mt == 1 ? 1 : 2;
  g.mz = ceil_div(mt, g.mw);
  g.ncw = ceil_div(w2, F_WIN);
  g.wd = round_up(ceil_div(w2, g.ncw), 8);
  g.cpr = g.wd / 8;
  g.groups = ceil_div(c_out, CG);
  const int target = g.mz >= 2 * SMS ? 1 : 2 * SMS / g.mz;
  DxGeometry best{};
  long long best_cost = -1;
  for (int r = 1; r <= h2 && r * g.cpr <= F_WARPS * (D_NTW / g.mw); ++r) {
    g.nb = ceil_div(h2, r);
    g.rows = ceil_div(h2, g.nb);
    if (g.rows != r) continue;  // the same cut as a lower height
    dx_layout(g);
    if (g.smem > SMEM_MOST) break;
    const long long total = (long long)n * g.nb * g.ncw;
    if (total > 0x7fffffffLL) continue;
    g.total = (int)total;
    g.per = ceil_div(g.total, target);
    const long long cost =
        (long long)g.per * (g.groups * ((long long)CG * (r + 1) * g.lp * 16 + F_STAGE_COST) +
                            2LL * 4 * r * g.wd * 16 * g.mw);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  if (best_cost < 0) return DxGeometry{};
  g = best;
  g.bq = h2 / g.nb;
  g.br = h2 % g.nb;
  g.blocks = ceil_div(g.total, g.per);
  g.lsh_l = log2_lanes(g.lp);
  g.cpr_mul = (65536 + g.cpr - 1) / g.cpr;  // exact for t < 65536 / cpr
  return g;
}

// Land dy channels o0 .. o0+15 of dy rows y0 .. y0+xr-1, columns x0 .. x0 +
// 8*lp - 1, as 16-byte pieces: piece j of channel row (ch, r) at (ch*lpc +
// r*lp + j)*8, zero past the image and past C_out (the last piece is the
// halo, of which transpose_dx keeps the first pixel).  A group of 2^lsh_l
// lanes lands one channel row, one piece a lane.  Needs W/2 % 8 == 0 and dy
// 16-byte aligned, so a piece is in or out as a whole (x0 is a multiple of
// 8).
__device__ __forceinline__ void land_dx(bf16* land, const bf16* dyn, int o0, int c_out, int H2,
                                        int W2, long long L4, int y0, int x0, int xr,
                                        const DxGeometry& g, int warp, int lane) {
  const int per = 32 >> g.lsh_l, j = lane & ((1 << g.lsh_l) - 1);
  if (j >= g.lp) return;
  const int gx = x0 + 8 * j;
  const int nch = min(CG, c_out - o0);
  for (RowWalk w(warp * per + (lane >> g.lsh_l), xr); w.c < CG; w.advance(F_WARPS * per, xr)) {
    const int gy = y0 + w.r;
    const bool in = w.c < nch && gy < H2 && gx < W2;
    cp_async16(land + (w.c * g.lpc + w.r * g.lp + j) * 8,
               in ? dyn + (long long)(o0 + w.c) * L4 + (long long)gy * W2 + gx : dyn,
               in ? 16 : 0);
  }
}

// The landing to xs, channel-innermost: pixel p of landed row r (dy column
// x0 + p; piece j holds p = 8j .. 8j+7) to (r*rowp + p)*CP, for p <= wd: of
// the halo piece (j = cpr) only p = wd is kept.  Item (r, jp) of xr x npair,
// the warps taking items in turn: one ldmatrix.x4.trans, whose 8-row
// matrices are 8 channels of pieces 2jp and 2jp+1, gives lane (g, q)
// channels 2q, 2q+1 (and 8+2q, 9+2q) of pixel g of each piece, four 32-bit
// stores.  The 8 channel rows are lpc pieces apart (odd), so the loads hit 8
// distinct bank groups; pixel g's words 12g + q (+ 4) fall in 32 distinct
// banks, so the stores do.
__device__ __forceinline__ void transpose_dx(bf16* xs, const bf16* land, const DxGeometry& g,
                                             int xr, int warp, int lane) {
  const int gq = lane >> 2, q = lane & 3, hi = lane >> 4;
  for (int it = warp; it < xr * g.npair; it += F_WARPS) {
    const int r = it / g.npair, j = 2 * (it - r * g.npair);
    const bool two = j + 1 < g.lp;
    uint32_t v[4];
    // no second piece: the upper lanes re-read the first
    ldmatrix_x4_trans(v, land + ((lane & 15) * g.lpc + r * g.lp + j + (two ? hi : 0)) * 8);
    bf16* dst = xs + (r * g.rowp + 8 * j + gq) * CP + 2 * q;
    if (j < g.cpr || gq == 0) {
      *reinterpret_cast<uint32_t*>(dst) = v[0];
      *reinterpret_cast<uint32_t*>(dst + 8) = v[1];
    }
    if (two && (j + 1 < g.cpr || gq == 0)) {
      *reinterpret_cast<uint32_t*>(dst + 8 * CP) = v[2];
      *reinterpret_cast<uint32_t*>(dst + 8 * CP + 8) = v[3];
    }
  }
}

// xs element by element, for rows that are not 16-byte aligned: dy column x0
// + p to pixel p, p = 0 .. wd, zero past the image and past C_out.
__device__ __forceinline__ void stage_dx_scalar(bf16* xs, const bf16* dyn, int o0, int c_out,
                                                int H2, int W2, long long L4, int y0, int x0,
                                                int xr, const DxGeometry& g, int tid) {
  const int cols = g.wd + 1;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < CG * xr * cols; e += F_NTH) {
    const int p = e % cols, cr = e / cols;
    const int r = cr % xr, ch = cr / xr;
    const int gy = y0 + r, gx = x0 + p;
    const bool in = o0 + ch < c_out && gy < H2 && gx < W2;
    xs[(r * g.rowp + p) * CP + ch] =
        in ? dyn[(long long)(o0 + ch) * L4 + (long long)gy * W2 + gx] : zero;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid (blocks, mz), F_NTH threads, at most 128 registers each (two blocks
// an SM).  vec_x: W/2 % 8 == 0 and dy and dx 16-byte aligned (cp.async
// landing, 8-byte stores); vec_w: the wall's rows are (see stage_wall).
template <int MW>
__global__ void __launch_bounds__(F_NTH, 2)
conv3x3s2_dx_mma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w_all,
                        bf16* __restrict__ dx, int c_in, int c_out, int H, int W, DxGeometry g,
                        int vec_x, int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NTW = D_NTW / MW;
  bf16* ws0 = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H2 = H / 2, W2 = W / 2;
  const int i0 = blockIdx.y * 16 * MW;
  const int t_first = blockIdx.x * g.per;
  const int stages = (min(g.total, t_first + g.per) - t_first) * g.groups;
  const long long L = (long long)H * W, L4 = (long long)H2 * W2;
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s & 1) * g.land_bytes);
  };
  // Stage s is output-channel group gi of tile t_first + s / groups: image
  // n, dy rows y0 .. y0+rb-1, window columns x0 ..
  auto origin = [&](int s, int& n, int& y0, int& rb, int& x0, int& gi) {
    stage_origin(g, t_first, s, n, y0, rb, x0, gi);
  };
  // Stage s's pieces into landing buffer s & 1 (the rb + 1 dy rows its band
  // reads), with stage 0 the block's whole wall: one commit group, empty
  // past the last stage.
  auto prefetch = [&](int s) {
    if (s < stages) {
      int n, y0, rb, x0, gi;
      origin(s, n, y0, rb, x0, gi);
      if (vec_x)
        land_dx(land_of(s), dy + (long long)n * c_out * L4, gi * CG, c_out, H2, W2, L4, y0, x0,
                rb + 1, g, warp, lane);
      if (s == 0)
        for (int k = 0; k < MW * g.groups; ++k)
          stage_wall<1>(ws0 + k * WSL, w_all, i0 + 16 * (k / g.groups), c_in, c_out,
                        16 * (k % g.groups), vec_w, tid);
    }
    cp_async_commit();
  };

  // A = wall_t^T (16 input x 16 output channels) by ldmatrix.x4.trans of
  // the slice's rows (t, o): lane row o = (lane & 7) + 8*(lane >> 4), input
  // channels 8*((lane >> 3) & 1) ..
  const int a_lane = ((lane & 7) + 8 * (lane >> 4)) * CP + ((lane >> 3) & 1) * 8;
  float acc[MW][NTW][4][4];  // [m-tile][slot][class 2*py + px][m16n8 element]
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][c][e] = 0.f;
  // Slot j of this warp is n-tile t = j*F_WARPS + warp of a band: dy row t /
  // cpr, columns 8*(t % cpr) .. +7.  Slots past the band's last row are idle
  // (their B lanes read slot 0's pixels).  boff[p]: the lane's ldmatrix row
  // of slot pair p at shift (0, 0).
  const auto row_of = [&](int t) { return (t * g.cpr_mul) >> 16; };
  int boff[NTW / 2];
#pragma unroll
  for (int p = 0; p < NTW / 2; ++p) {
    int t = (2 * p + (lane >> 4)) * F_WARPS + warp;
    if (t >= g.rows * g.cpr) t = 0;
    const int row = row_of(t);
    boff[p] = (row * g.rowp + 8 * (t - row * g.cpr) + (lane & 7)) * CP + ((lane >> 3) & 1) * 8;
  }
  int nvalid = 0;

  prefetch(0);
  prefetch(1);
  for (int s = 0; s < stages; ++s) {
    int n, y0, rb, x0, gi;
    origin(s, n, y0, rb, x0, gi);
    cp_async_wait_prior();
    __syncthreads();  // stage s (and with stage 0 the wall) has landed; the block is done with xs
    if (vec_x)
      transpose_dx(xs, land_of(s), g, rb + 1, warp, lane);
    else
      stage_dx_scalar(xs, dy + (long long)n * c_out * L4, gi * CG, c_out, H2, W2, L4, y0, x0,
                      rb + 1, g, tid);
    __syncthreads();  // xs holds stage s; its landing buffer is free
    prefetch(s + 2);

    if (gi == 0) {
      const int nslots = rb * g.cpr;
      nvalid = warp < nslots ? (nslots - warp + F_WARPS - 1) / F_WARPS : 0;
    }
    // Tap (ki, kj) adds wall_t^T . dy(r + dr, c + dc) into class (py, px) of
    // dy pixel (r, c), dx pixel (2r + py, 2c + px): ki = 1 gives (py, dr) =
    // (0, 0), ki = 2 (1, 0), ki = 0 (1, 1); kj likewise (px, dc).  Shift sh
    // = 2*dr + dc is an address offset in xs: its B fragments are one
    // ldmatrix.x4 a slot pair, loaded before the taps that read them.
    const bf16* wsg = ws0 + gi * WSL + a_lane;
#pragma unroll
    for (int p = 0; p < NTW / 2; ++p) {
      if (2 * p >= nvalid) continue;
      const bool both = 2 * p + 1 < nvalid;
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) {
        uint32_t b[4];
        ldmatrix_x4(b, xs + boff[p] + ((sh >> 1) * g.rowp + (sh & 1)) * CP);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int ki = t / 3, kj = t % 3;
          if (2 * (ki == 0) + (kj == 0) != sh) continue;
          const int cls = 2 * (ki != 1) + (kj != 1);
          uint32_t a[MW][4];
#pragma unroll
          for (int m = 0; m < MW; ++m)
            ldmatrix_x4_trans(a[m], wsg + (m * g.groups * 9 + t) * 16 * CP);
#pragma unroll
          for (int m = 0; m < MW; ++m) mma_acc(acc[m][2 * p][cls], a[m], b[0], b[1]);
          if (both) {
#pragma unroll
            for (int m = 0; m < MW; ++m) mma_acc(acc[m][2 * p + 1][cls], a[m], b[2], b[3]);
          }
        }
      }
    }
    if (gi + 1 < g.groups) continue;

    // The tile's last group: the sums straight to dx.  acc[m][j][2py + px]
    // holds input channels i0 + 16m + gq (e < 2) and + 8 (e >= 2) at dy
    // columns 2q + (e & 1) of slot j's n-tile (the m16n8 accumulator
    // layout), so lane (gq, q) holds dx columns 4q .. 4q+3 of the n-tile's
    // 16 in rows 2r and 2r + 1: one 8-byte store a row and channel, the four
    // lanes of a group one 32-byte sector.
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < nvalid) {
        const int t = j * F_WARPS + warp, row = row_of(t);
        const int c = x0 + 8 * (t - row * g.cpr);  // the n-tile's first dy column
        bf16* dn = dx + (long long)n * c_in * L + (long long)(2 * (y0 + row)) * W + 2 * c;
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ch = i0 + 16 * m + gq + 8 * hh;
            if (ch >= c_in) continue;
            bf16* dc = dn + ch * L;
#pragma unroll
            for (int py = 0; py < 2; ++py) {
              const float(&e0)[4] = acc[m][j][2 * py];      // px = 0
              const float(&e1)[4] = acc[m][j][2 * py + 1];  // px = 1
              if (vec_x) {
                if (c < W2)
                  *reinterpret_cast<uint2*>(dc + py * W + 4 * q) =
                      make_uint2(pack_bf16x2(e0[2 * hh], e1[2 * hh]),
                                 pack_bf16x2(e0[2 * hh + 1], e1[2 * hh + 1]));
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (c + 2 * q + e < W2) {
                    dc[py * W + 4 * q + 2 * e] = __float2bfloat16_rn(e0[2 * hh + e]);
                    dc[py * W + 4 * q + 2 * e + 1] = __float2bfloat16_rn(e1[2 * hh + e]);
                  }
              }
            }
          }
      }
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][c][e] = 0.f;
    }
  }
}

template <int MW>
cudaError_t launch_dx_mw(const bf16* dy, const bf16* w_all, bf16* dx, int c_in, int c_out, int h,
                         int w, const DxGeometry& g, int vec_x, int vec_w, cudaStream_t stream) {
  const cudaError_t err = allow_smem<conv3x3s2_dx_mma_kernel<MW>>();
  if (err != cudaSuccess) return err;
  conv3x3s2_dx_mma_kernel<MW><<<dim3(g.blocks, g.mz), F_NTH, g.smem, stream>>>(
      dy, w_all, dx, c_in, c_out, h, w, g, vec_x, vec_w);
  return cudaGetLastError();
}

// K4dx, bf16.
cudaError_t launch_dx_mma(const void* dy, const void* w_all, void* dx, int n, int c_in,
                          int c_out, int h, int w, cudaStream_t stream) {
  const DxGeometry g = dx_geometry(n, c_in, c_out, h, w);
  if (g.total < 1 || g.smem > SMEM_MOST || g.mz > 65535) return cudaErrorInvalidConfiguration;
  const int vec_x = (w / 2) % 8 == 0 && aligned(dy) && aligned(dx);
  const int vec_w = c_in % 8 == 0 && aligned(w_all);
  const bf16* dp = static_cast<const bf16*>(dy);
  const bf16* wp = static_cast<const bf16*>(w_all);
  bf16* op = static_cast<bf16*>(dx);
  if (g.mw == 1) return launch_dx_mw<1>(dp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
  return launch_dx_mw<2>(dp, wp, op, c_in, c_out, h, w, g, vec_x, vec_w, stream);
}

}  // namespace tc

// ------------------------------------------------------------ launchers

// K4, f32.
cudaError_t launch_fwd_f32(const void* x, const void* w_all, void* out, int n,
                           int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const dim3 grid((w / 2 + F_TW - 1) / F_TW, (h / 2 + F_TH - 1) / F_TH, n);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w_all);
  float* op = static_cast<float*>(out);
  if (c_out <= 16)
    conv3x3s2_fwd_kernel<16><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else if (c_out <= 32)
    conv3x3s2_fwd_kernel<32><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  else
    conv3x3s2_fwd_kernel<64><<<grid, F_NT, 0, stream>>>(xp, wp, op, c_in, c_out, h, w);
  return cudaGetLastError();
}

// K4dx, f32.
cudaError_t launch_dx_f32(const void* dy, const void* w_all, void* dx, int n,
                          int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const int groups = (c_in + D_CIG - 1) / D_CIG;
  const dim3 grid((w / 2 + D_TW - 1) / D_TW, (h / 2 + D_TH - 1) / D_TH, n * groups);
  conv3x3s2_dx_kernel<<<grid, D_NT, 0, stream>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w_all), static_cast<float*>(dx),
      c_in, c_out, h, w, groups);
  return cudaGetLastError();
}

// K4dw, f32: the CUDA-core partial sums, then the slots' reduce.
cudaError_t launch_dw_f32(const float* x, const float* dy, float* ws, float* out, int n,
                          int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Geometry g = geometry(n, c_in, h, w);
  const dim3 grid(g.chunks, n, g.groups);
  if (c_out <= 16)
    conv3x3s2_dw_partial_kernel<16><<<grid, CI_T * 16 / 4, 0, stream>>>(
        x, dy, ws, c_in, c_out, h, w, g);
  else if (c_out <= 32)
    conv3x3s2_dw_partial_kernel<32><<<grid, CI_T * 32 / 4, 0, stream>>>(
        x, dy, ws, c_in, c_out, h, w, g);
  else
    conv3x3s2_dw_partial_kernel<64><<<grid, CI_T * 64 / 4, 0, stream>>>(
        x, dy, ws, c_in, c_out, h, w, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(ws, out, n * g.chunks, c_in, c_out, stream);
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
// bfloat16 (is_bf16 = 1).  bf16 runs on the tensor cores, f32 on the CUDA
// cores.  Returns a cudaError_t as int.
int conv3x3s2(const void* x, const void* w_all, void* out, int n, int c_in,
              int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
                              ? tc::launch_fwd_mma(x, w_all, out, n, c_in, c_out, h, w, s)
                              : launch_fwd_f32(x, w_all, out, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// K4dx.  dy: (n, c_out, h/2*w/2), w_all: (c_out, 9*c_in), dx: (n, c_in,
// h*w), as above.  bf16 runs on the tensor cores, f32 on the CUDA cores.
// Returns a cudaError_t as int.
int conv3x3s2_dx(const void* dy, const void* w_all, void* dx, int n, int c_in,
                 int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? tc::launch_dx_mma(dy, w_all, dx, n, c_in, c_out, h, w, s)
              : launch_dx_f32(dy, w_all, dx, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3s2_dw needs for these shapes and this dtype
// (0 if invalid): the slots of the route that runs, the tensor-core one
// for bfloat16 (is_bf16 = 1), the CUDA-core one for float32.
long long conv3x3s2_dw_workspace(int n, int c_in, int c_out, int h, int w, int is_bf16) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  const long long slots = is_bf16 ? tc::geometry(n, c_in, c_out, h, w).slots
                                  : (long long)n * geometry(n, c_in, h, w).chunks;
  return slots * 9 * c_in * c_out;
}

// K4dw.  x: (n, c_in, h*w), dy: (n, c_out, h/2*w/2), as above; ws: at least
// conv3x3s2_dw_workspace(...) floats; out: (9*c_in, c_out) float32, row
// t*c_in + i.  bf16 runs on the tensor cores, f32 on the CUDA cores.
// Returns a cudaError_t as int.
int conv3x3s2_dw(const void* x, const void* dy, void* ws, void* out, int n,
                 int c_in, int c_out, int h, int w, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? tc::launch(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch_dw_f32(static_cast<const float*>(x), static_cast<const float*>(dy), wsp,
                              op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3s2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
