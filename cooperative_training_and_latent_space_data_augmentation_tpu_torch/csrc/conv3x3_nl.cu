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
//   out[n, o, y*W + x] = sum_{ki, kj, i} w_all[o, (3*ki + kj)*C_in + i]
//                                        * x[n, i, (y+ki-1)*W + (x+kj-1)]
//   dw[t*C_in + i, o]  = sum_{n, p} P[(n, p), t*C_in + i] * dy[n, o, p]
//
// with taps outside the image reading zero and f32 accumulation; the forward
// rounds once to the input type at the store, dw is returned in f32.  K5's
// input gradient is the forward on the flipped, transposed wall; with
// flip = 1 the forward reads that wall out of the unflipped one,
// w'[i, t*C_out + o] = w_all[o, (8-t)*C_in + i], so no flipped copy is made.
//
// What bounds K5 on the H100: at the main path's shapes (64->128, 128->128
// and 128->64 at 24^2, 128->128 at 12^2, batch 20; dx the same four mirrored)
// an output pixel carries 2*9*C_in*C_out operations on 2*(C_in + C_out)
// bytes, 384..576 operations a byte, above the card's 295 for bf16 on the
// tensor cores: bound by operations, 0.86 us (128->128 @ 12^2) to 3.44 us
// (128->128 @ 24^2) a launch at 989 TFLOP/s.  On the CUDA cores the same work
// cannot take less than about 51 us at 128->128 @ 24^2 (67 TFLOP/s of f32).
//
// bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// out), out (C_out x pixels) = wall (C_out x 9*C_in) . P, with M = 16 output
// channels, N = 8 pixels, a k-step = 16 input channels of one tap.  P is
// never built.  Against the gathered design it replaces:
//
//   * One staged tile for all nine taps.  A block owns a tile of whole rows
//     of one image (a band; the tile is a column window only for rows too
//     wide to stage) and 32 output channels.  For each stage of 32 input
//     channels it stages the band with a one-row halo above and below and a
//     zero column at each side, channel-innermost: pixel (r, s) at
//     (r*swp + s)*CP, 32 channels padded to CP = 40 (80 bytes, so the 8
//     pixels of a fragment load fall in 8 distinct bank groups; swp = wd + 2,
//     or wd + 8 where 8-pixel groups cross rows).  The nine taps are offsets
//     (ki*swp + kj)*CP into that one tile: x is read once per block and stage
//     and the edge masks are zeros in shared memory.
//   * Loads overlap the products.  x lands by 16-byte cp.async as the band's
//     flat run of pixels (its rows are contiguous in CHW), two stages ahead,
//     into two landing buffers; one ldmatrix.x4.trans on the 32 channel rows
//     of a 16-byte piece gives each lane four channel pairs of one pixel,
//     stored into the tile (shared to shared).  The wall's slice of a stage
//     (9 taps x 32 output channels x 32 input channels) lands by cp.async
//     straight into its final layout, in three buffers, also two ahead.  The
//     warps run mma.sync on stage s while stages s+1 and s+2 are in flight.
//   * Fragments by ldmatrix.x4: B (two n-tiles) from the pixel tile, A from
//     the wall's rows of 64 bytes, whose four 16-byte units sit XOR-swizzled
//     (unit u of row r at u ^ ((r >> 1) & 3)), conflict-free without padding.
//   * The grid fills the card: bands get shorter while the grid still fits
//     two blocks on each of the 132 SMs at once (the shared memory allows
//     two); at N = 20 each of the four shapes takes 240 blocks (bands of 8
//     rows at 24^2 with 128 channels out, 4 rows with 64 out and at 12^2),
//     at N = 160 640..1920.  Its 8 warps are 2 k-groups x 4 pixel groups: a
//     warp takes one of the two k-steps of each tap for 2 m-tiles and up to 6
//     n-tiles, so it holds 48 accumulators and loads 5 fragments for 12
//     products; at the end the second k-group's sums go through shared
//     memory and the first adds them in a fixed order (two launches agree bit
//     for bit) and stores bf16 pairs.
//   * dx (flip = 1) reads rows of the unflipped wall, (8-t)*C_out + o0 ..
//     +31 for input channel c0 + k, into rows of k, and takes A by
//     ldmatrix.x4.trans: the flip is in the addresses.
//   * Edges as data: landing pieces outside the image plane, channels past
//     C_in and wall rows past C_out are zero (cp.async with a source size of
//     0).  Where the plane is not a multiple of 8 pixels (or x not 16-byte
//     aligned, or the band too wide to stage), x is staged element by element
//     (in column windows of at most 128 where rows are wider); where the
//     wall's rows are not (C_in, or C_out for dx, not a multiple of 8), the
//     wall is.
//
// f32 stays on the CUDA cores in full f32 (no TF32: the port's f32 convs are
// full f32): a block owns a 64 x 64 tile of (pixels x C_out) with 4 warps
// and 32 f32 accumulators a thread, and stages gathered 64 x 32 tiles of P
// and of the wall per step of 32 (flip = 1 reads the wall flipped).
//
// What bounds K5dw: the same products as K5 (bound by operations on the
// tensor cores: 3.4 us at 128->128 @ 24^2, batch 20), with the pixels as
// the reduction and a small output, (9*C_in, C_out) in f32.
//
// K5dw in bf16: an implicit GEMM on the tensor cores (tc::
// conv3x3_nl_dw_mma_kernel), dw (9*C_in x C_out) = P^T (9*C_in x pixels) .
// dY (pixels x C_out), with M = 16 input channels of one tap, N = 8 output
// channels, a k-step = 16 pixels:
//
//   * A block owns 32 input channels x 32 output channels x all 9 taps
//     (its tile: two m-tiles, four n-tiles, nine taps) and a slab of units,
//     a unit being a band of whole rows of one image (a column window where
//     rows are too wide).  For each unit it stages x's band with a one-row
//     halo and zero side columns channel-innermost, as K5 does (the same
//     flat-run landing and ldmatrix.x4.trans pass), and dy's band as it
//     lands: 32 channel rows of the band's flat pixel run (odd pitches of
//     16-byte pieces, so the 8 rows an ldmatrix reads fall in 8 distinct
//     bank groups).  Both land by cp.async two units ahead (two x landing
//     buffers, three dy buffers).  Bands are a multiple of 8 / gcd(W, 8)
//     rows, so each starts at a 16-byte piece of the plane.
//   * 6 warps = 3 kernel rows x 2 m-tiles.  For each k-step a warp loads B
//     (dy, four n-tiles) by two ldmatrix.x4 and, for each of its three taps,
//     A by one ldmatrix.x4.trans at the tap's offset into the staged x tile
//     (a lane gives the address of its own pixel, so k-steps may cross
//     rows): 5 fragment loads for 12 products, 48 accumulators.  The taps'
//     edge masks are the tile's zeros; k-step pixels past the band read dy
//     zeros (cp.async with a source size of 0).
//   * The grid is about one wave of two blocks an SM (at most 264 blocks:
//     16 slabs x 16 tiles at 128->128 @ 24^2, 30 x 8 at 64 channels on a
//     side, 10 x 16 at 12^2, batch 20; at most 128 registers a thread).
//     The slabs of a tile pair up into thread-block clusters of 2: at the
//     end each block puts its sums in shared memory, and each block of a
//     pair adds half of the tile over the pair in rank order, through
//     distributed shared memory, and writes it to the pair's workspace
//     slot (8 slots at 128->128 @ 24^2, 5 at 12^2, 15 at 64 channels;
//     straight into dw where a launch has one slot).  Clusters of 4 or 8
//     would halve the slots again, but at these grids they do not all fit
//     the card at once, and the rest runs as a second wave.
//
// f32 K5dw stays on the CUDA cores in full f32: a block owns a 64 x 64
// tile of (wall rows x C_out), gathers 32-pixel steps of P and dY, and sums
// a slab of pixels (about 528 blocks in all).
//
// Both: Hopper's blocks run in no order, so the TPU kernel's accumulation
// across its grid becomes two passes with a fixed summation order and no
// float atomics: pixels are cut into slabs (their number depends on the
// shapes only), each block (bf16: each cluster) writes the partial sum of
// its slab to a workspace slot of its own, and a second kernel adds the
// slots in slot order.  Two launches agree bit for bit.
//
// C interface (bound with ctypes): conv3x3_nl(...) and conv3x3_nl_dw(...)
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError() of the launches (0 on success);
// conv3x3_nl_dw_workspace(...) gives the workspace size in floats.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// f32 (CUDA cores)
constexpr int BM = 64;   // rows of a block's tile
constexpr int BN = 64;   // columns of a block's tile
constexpr int KK = 32;   // reduction depth of one staged step
constexpr int RS = KK + 4;  // staged row: the reduction index contiguous, padded
constexpr int NT = 128;  // threads: 4 warps, 2 x 2 over the tile
constexpr long long TARGET_BLOCKS = 528;  // K5dw: about four blocks per SM

// One staged step of this warp's 32 x 32 part: acc += A . B^T with A the
// (BM, KK) tile As[r * RS + k] and B the (BN, KK) tile Bs[c * RS + k].
// acc[mi][ni][e]: rows wr + 16*mi + g (+8 for e >= 2), columns
// wc + 8*ni + 2*q + (e & 1), with g = lane / 4, q = lane % 4.
__device__ __forceinline__ void step(const float* As, const float* Bs,
                                     float (&acc)[2][4][4], int wr, int wc, int lane) {
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

// K5 in f32.  Grid (ceil(M / BM), ceil(C_out / BN)).  Thread tid stages
// pixel row tid % BM of the P tile, input channels tid / BM + 2*s of the
// step.  flip = 1: w_all is (C_in, 9*C_out), read flipped and transposed.
__global__ void __launch_bounds__(NT)
conv3x3_nl_kernel(const float* __restrict__ x, const float* __restrict__ w_all,
                  float* __restrict__ out, int n_img, int c_in, int c_out, int H, int W,
                  int flip) {
  __shared__ __align__(16) float As[BM * RS];
  __shared__ __align__(16) float Bs[BN * RS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const int L = H * W;
  const long long M = (long long)n_img * L;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const float zero = 0.f;

  const int ar = tid % BM, aj = tid / BM;
  const long long m = m0 + ar;
  int img = 0, py = 0, px = 0;
  if (m < M) {
    img = (int)(m / L);
    const int p = (int)(m - (long long)img * L);
    py = p / W;
    px = p - py * W;
  }
  const float* xn = x + (long long)img * c_in * L;

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
    const float* xs = xn + sy * W + sx;
    for (int c0 = 0; c0 < c_in; c0 += KK) {
      __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll 4
      for (int s = 0; s < KK / 2; ++s) {
        const int j = aj + 2 * s;
        As[ar * RS + j] = (valid && c0 + j < c_in) ? xs[(long long)(c0 + j) * L] : zero;
      }
      for (int e = tid; e < BN * KK; e += NT) {
        const int o = e / KK, j = e % KK;
        float v = zero;
        if (o0 + o < c_out && c0 + j < c_in)
          v = flip ? w_all[(long long)(c0 + j) * 9 * c_out + (8 - t) * c_out + o0 + o]
                   : w_all[(long long)(o0 + o) * 9 * c_in + t * c_in + c0 + j];
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
      float* on = out + (long long)n * c_out * L + p;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wc + 8 * ni + 2 * q + e;
          if (o < c_out) on[(long long)o * L] = acc[mi][ni][2 * h + e];
        }
    }
}

// K5dw, pass 1.  Grid (ceil(9*C_in / BM), ceil(C_out / BN), slabs): the
// block's (BM, BN) tile of dw summed over the pixels [slab * z, min(M,
// slab * (z+1))), written to workspace slot z.  Thread tid stages pixel
// tid % KK of the step for wall rows (or output channels) tid / KK + 4*s.
__global__ void __launch_bounds__(NT)
conv3x3_nl_dw_partial(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ ws, int n_img, int c_in, int c_out, int H,
                      int W, long long slab) {
  __shared__ __align__(16) float As[BM * RS];
  __shared__ __align__(16) float Bs[BN * RS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const int L = H * W;
  const int K = 9 * c_in;
  const long long M = (long long)n_img * L;
  const int k0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const long long s0 = slab * blockIdx.z;
  const long long s1 = min(M, s0 + slab);
  const float zero = 0.f;
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
    const float* xn = x + (long long)img * c_in * L;
    const float* dn = dy + (long long)img * c_out * L + p;
    __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll 4
    for (int s = 0; s < BM / 4; ++s) {
      const int r = pr + 4 * s;
      const int k = k0 + r;
      float v = zero;
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
         (c_out + BN - 1) / BN <= 65535 && (long long)(h + 2) * w <= 0x7fffffffLL &&
         (long long)c_in * h * w <= 0x7fffffffLL && (long long)c_out * h * w <= 0x7fffffffLL &&
         9LL * (c_in + 32) * (c_out + 32) <= 0x7fffffffLL;  // K5's 32-bit offsets
}

cudaError_t launch_fwd_f32(const void* x, const void* w_all, void* out, int n, int c_in,
                           int c_out, int h, int w, int flip, cudaStream_t stream) {
  const long long M = (long long)n * h * w;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (c_out + BN - 1) / BN);
  conv3x3_nl_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_all), static_cast<float*>(out),
      n, c_in, c_out, h, w, flip);
  return cudaGetLastError();
}

// Adds the `parts` workspace slots of a K5dw launch into out.
cudaError_t launch_dw_reduce(const float* ws, float* out, int parts, int c_in, int c_out,
                             cudaStream_t stream) {
  const long long k = 9LL * c_in * c_out;
  const int threads = 256;
  conv3x3_nl_dw_reduce<<<(unsigned)((k + threads - 1) / threads), threads, 0, stream>>>(
      ws, out, parts, k);
  return cudaGetLastError();
}

cudaError_t launch_dw_f32(const void* x, const void* dy, float* ws, float* out, int n,
                          int c_in, int c_out, int h, int w, cudaStream_t stream) {
  const Slabs s = slabs(n, c_in, c_out, h, w);
  const dim3 grid((9 * c_in + BM - 1) / BM, (c_out + BN - 1) / BN, s.parts);
  conv3x3_nl_dw_partial<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), ws, n, c_in, c_out, h, w,
      s.slab);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce(ws, out, s.parts, c_in, c_out, stream);
}

// ---------------------------------------------------------------------------
// K5 in bf16: tensor cores (see the note at the top).

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int OPB = 32;                 // output channels of a block: two m-tiles
constexpr int CG = 32;                  // input channels of a stage: two k-steps
constexpr int WN = 4;                   // pixel groups of warps in each k-group
constexpr int NTW = 6;                  // most n-tiles (8 pixels each) a warp owns
constexpr int MAX_PIX = WN * NTW * 8;   // most pixels of a tile (192)
constexpr int MAX_WIN = 128;            // most columns of a window, where x is staged element-wise
constexpr int CP = CG + 8;              // staged elements a pixel (80 bytes)
constexpr int WROW = 32;                // elements of a wall row (64 bytes, swizzled)
constexpr int WSLICE = 9 * OPB * CG;    // elements of a stage's wall slice
constexpr int WBUFS = 3;                // wall slices in flight or in use
constexpr int SMS = 132;                // SMs of an H100
constexpr int SMEM_MOST = 113 * 1024;   // so that two blocks fit an SM
constexpr int WD_SHIFT = 20;            // q / wd == (q * wd_mul) >> WD_SHIFT
static_assert(WN * NTW * 2 * 4 * 32 * 4 <= WBUFS * WSLICE * 2,
              "the second k-group's sums fit the wall buffers");

// How a launch is cut.  A tile is `rows` rows of a window of `wd` columns of
// one image (wd == W unless rows of W are too wide to stage): `ncw` windows
// across a row, `bands` bands down the image, `tiles` in all (grid.x); `mz`
// blocks of OPB output channels (grid.y).  A tile has `npix` = rows * wd
// pixels, `nt` n-tiles of 8 in row-major order (an n-tile may cross rows).
// vec_x: x lands by cp.async as each band's flat run of pixels (whole rows,
// H*W % 8 == 0, x 16-byte aligned), into landing buffers of CG channel rows
// of `lpc` 16-byte pieces (odd, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups); else it is staged element by element.  Shared
// memory: the WBUFS wall slices, the pixel tile xs ((rows + 2) x swp pixels
// of CP elements) at xs_off, and two landing buffers at land_off.
struct Geometry {
  int mz, wd, ncw, rows, bands, tiles, npix, nt, swp, vec_x, lpc, wd_mul;
  int xs_off, land_off, land_bytes, smem;  // bytes
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The pixel tile's pitch for windows of wd columns: a zero column on each
// side, and wd + 8 where 8-pixel groups cross rows (wd % 8 != 0), so the 8
// pixels of an ldmatrix still fall in 8 distinct bank groups.
inline int tile_pitch(int wd) { return wd % 8 == 0 ? wd + 2 : wd + 8; }

// 16-byte pieces of a landing buffer's channel row for bands of `rows` rows
// of W pixels: a band's run starts at (y0-1)*W rounded down to 8 and spans
// (rows+2)*W pixels.  Odd, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups.
inline int run_pitch(int rows, int W) { return ((rows + 2) * W + 14) / 8 | 1; }

void layout(Geometry& g, int W) {
  const int r2 = g.rows + 2;
  g.npix = g.rows * g.wd;
  g.nt = ceil_div(g.npix, 8);
  g.swp = tile_pitch(g.wd);
  g.xs_off = WBUFS * WSLICE * 2;
  g.land_off = g.xs_off + r2 * g.swp * CP * 2;
  g.lpc = g.vec_x ? run_pitch(g.rows, W) : 0;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + 2 * g.land_bytes;
}

Geometry geometry(int n, int c_out, int h, int w, bool aligned) {
  Geometry g;
  g.mz = ceil_div(c_out, OPB);
  g.vec_x = aligned && (long long)h * w % 8 == 0 && w <= MAX_PIX;
  for (;;) {
    g.ncw = g.vec_x || w <= MAX_WIN ? 1 : ceil_div(w, MAX_WIN);
    g.wd = ceil_div(w, g.ncw);
    int most = MAX_PIX / g.wd;
    if (most > h) most = h;
    if (most < 1) most = 1;
    // more, shorter bands (balanced) while the grid still fits two blocks an
    // SM at once
    int bands = ceil_div(h, most);
    while (bands < h && (long long)g.mz * n * (bands + 1) * g.ncw <= 2 * SMS) ++bands;
    g.rows = ceil_div(h, bands);
    for (;;) {
      layout(g, w);
      if (g.smem <= SMEM_MOST || g.rows == 1) break;
      --g.rows;
    }
    if (g.smem <= SMEM_MOST || !g.vec_x) break;
    g.vec_x = 0;  // whole rows too wide to land: element-wise, in windows
  }
  g.bands = ceil_div(h, g.rows);
  const long long tiles = (long long)n * g.bands * g.ncw;
  g.tiles = tiles > 0x7fffffffLL ? -1 : (int)tiles;
  g.wd_mul = (1 << WD_SHIFT) / g.wd + 1;  // exact for q * wd < 2^20 (q < 3 * MAX_PIX)
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

// Staging a band of x channel-innermost, for K5 and K5dw.  A band's rows
// y0-1 .. y0+rows (a one-row halo) are the plane's pixels [lo, lo + span),
// contiguous in CHW.  vec (H*W % 8 == 0, x 16-byte aligned): they land as
// 16-byte pieces from pstart (lo rounded down to 8), each wholly in or out
// of the plane, and an ldmatrix.x4.trans pass turns them into the tile
// xs, pixel (r, s) of the band's rows at (r*swp + s + 1)*CP; else they are
// staged element by element.
struct Run {
  int lo, pstart, span, npieces;
};

__device__ __forceinline__ Run band_run(int y0, int rows, int W) {
  Run r;
  r.lo = (y0 - 1) * W;
  r.pstart = r.lo >= 0 ? r.lo / 8 * 8 : -((7 - r.lo) / 8 * 8);
  r.span = (rows + 2) * W;
  r.npieces = (r.lo + r.span + 7 - r.pstart) / 8;
  return r;
}

// cp.async of the run's pieces of CG channel rows: channel ch from xc +
// ch*L (zero for ch >= nch and outside the plane) to piece row ch of land
// (lpc pieces a row).  Warp w of NW lands rows w, w + NW, ...; lanes walk
// the pieces.
template <int NW>
__device__ __forceinline__ void land_run(bf16* land, const bf16* xc, int nch, const Run& r,
                                         int L, int lpc, int warp, int lane) {
  for (int j = lane; j < r.npieces; j += 32) {
    const int p = r.pstart + 8 * j;
    const bool in = p >= 0 && p < L;
#pragma unroll
    for (int ch = warp; ch < CG; ch += NW) {
      const bool v = in && ch < nch;
      cp_async16(land + (ch * lpc + j) * 8, v ? xc + ch * L + p : xc, v ? 16 : 0);
    }
  }
}

// land -> xs: warp w of NW takes pieces w, w + NW, ...; one
// ldmatrix.x4.trans on a piece's 32 channel rows gives lane (gq, q)
// channels 8m+2q, 8m+2q+1 (m = 0..3) of the piece's pixel gq.
template <int NW>
__device__ __forceinline__ void turn_run(bf16* xs, const bf16* land, const Run& r, int W,
                                         int swp, int lpc, int wd_mul, int warp, int lane) {
  const int gq = lane >> 2, q = lane & 3;
  for (int j = warp; j < r.npieces; j += NW) {
    uint32_t v[4];
    ldmatrix_x4_trans(v, land + (lane * lpc + j) * 8);
    const int Q = r.pstart - r.lo + 8 * j + gq;  // pixel of the band's rows
    if (Q >= 0 && Q < r.span) {
      const int row = (int)(((unsigned)Q * (unsigned)wd_mul) >> WD_SHIFT);
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(xs + (row * swp + Q - row * W + 1) * CP + 2 * q);
#pragma unroll
      for (int m = 0; m < 4; ++m) dst[4 * m] = v[m];
    }
  }
}

// vec: the zero columns on each side of a tile of r2 rows; the passes above
// rewrite every other pixel a tap reads.
template <int NT_>
__device__ __forceinline__ void zero_side_columns(bf16* xs, int r2, int swp, int W, int tid) {
  uint32_t* z = reinterpret_cast<uint32_t*>(xs);
  for (int e = tid; e < r2 * CP; e += NT_) {
    const int r = e / CP, word = e % (CP / 2), right = e % CP >= CP / 2;
    z[(r * swp + (right ? W + 1 : 0)) * (CP / 2) + word] = 0u;
  }
}

// Element by element: rows y0-1 .. y0+rows, columns x0-1 .. x0+wd of CG
// channels from xc (zero for ch >= nch and outside the image) into xs.
template <int NT_>
__device__ __forceinline__ void stage_band(bf16* xs, const bf16* xc, int nch, int y0, int x0,
                                           int rows, int wd, int swp, int H, int W, int tid) {
  const int r2 = rows + 2, cols = wd + 2, L = H * W;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < CG * r2 * cols; e += NT_) {
    const int ch = e % CG, rs = e / CG;
    const int sc = rs % cols, r = rs / cols;
    const int gy = y0 - 1 + r, gx = x0 - 1 + sc;
    const bool in = ch < nch && gy >= 0 && gy < H && gx >= 0 && gx < W;
    xs[(r * swp + sc) * CP + ch] = in ? xc[ch * L + gy * W + gx] : zero;
  }
}

// Element e (0..31) of wall row r (0 .. 9*32-1) in a slice: 16-byte unit
// e / 8 sits at unit (e / 8) ^ ((r >> 1) & 3), so the 8 rows an ldmatrix
// reads at one unit fall in 8 distinct bank groups.
__device__ __forceinline__ int wall_at(int r, int e) {
  return r * WROW + 8 * ((e >> 3) ^ ((r >> 1) & 3)) + (e & 7);
}

// The wall slice of the stage's input channels c0 .. c0+31 for the block's
// output channels o0 .. o0+31, row r = t*32 + i of tap t:
//   flip = 0: row i is output channel o0+i, element k = w_all[(o0+i)*9*c_in
//             + t*c_in + c0+k] (A row-major: ldmatrix);
//   flip = 1: row i is input channel c0+i, element m = w_all[(c0+i)*9*c_out
//             + (8-t)*c_out + o0+m] (w_all is the forward's wall, (c_in,
//             9*c_out); A column-major: ldmatrix.trans).
// Zero past C_in and C_out.  Offsets fit 32 bits (valid()).  vec: the
// rows' 16-byte units are aligned
// (c_in, or c_out for flip, a multiple of 8, w_all 16-byte aligned), one
// cp.async each; else element by element.
template <bool FLIP>
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* w_all, int c0, int c_in,
                                        int c_out, int o0, int vec, int tid) {
  if (vec) {
    for (int e = tid; e < 9 * 32 * 4; e += THREADS) {
      const int u = e & 3, r = e >> 2, t = r >> 5, i = r & 31;
      const bool in = FLIP ? c0 + i < c_in && o0 + 8 * u < c_out
                           : o0 + i < c_out && c0 + 8 * u < c_in;
      const bf16* src = w_all + (FLIP ? ((c0 + i) * 9 + 8 - t) * c_out + o0 + 8 * u
                                      : ((o0 + i) * 9 + t) * c_in + c0 + 8 * u);
      cp_async16(ws + wall_at(r, 8 * u), in ? src : w_all, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < 9 * 32 * 32; e += THREADS) {
      const int k = e & 31, r = e >> 5, t = r >> 5, i = r & 31;
      bf16 v = zero;
      if (FLIP) {
        if (c0 + i < c_in && o0 + k < c_out) v = w_all[((c0 + i) * 9 + 8 - t) * c_out + o0 + k];
      } else if (o0 + i < c_out && c0 + k < c_in) {
        v = w_all[((o0 + i) * 9 + t) * c_in + c0 + k];
      }
      ws[wall_at(r, k)] = v;
    }
  }
}

// Grid (tiles, mz); THREADS threads.  flip: see stage_w.
template <bool FLIP>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_nl_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_all,
                      bf16* __restrict__ out, int c_in, int c_out, int H, int W,
                      Geometry g, int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp / WN, wn = warp % WN;  // k-group, pixel group
  const int o0 = blockIdx.y * OPB;
  const int per_image = g.bands * g.ncw;
  const int n = blockIdx.x / per_image;
  const int b = blockIdx.x - n * per_image;
  const int band = b / g.ncw;
  const int y0 = band * g.rows, x0 = (b - band * g.ncw) * g.wd;
  const int L = H * W;  // offsets inside one image fit 32 bits (valid())
  const bf16* xn = x + (long long)n * c_in * L;
  bf16* outn = out + (long long)n * c_out * L;
  const int stages = (c_in + CG - 1) / CG;

  const Run run = band_run(y0, g.rows, W);
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s & 1) * g.land_bytes);
  };
  // Stage s's x pieces (vec_x) and its wall slice: one commit group, empty
  // past the last stage.
  auto issue = [&](int s) {
    if (s < stages) {
      const int c0 = s * CG;
      if (g.vec_x) land_run<WARPS>(land_of(s), xn + c0 * L, c_in - c0, run, L, g.lpc, warp, lane);
      stage_w<FLIP>(wbuf + (s % WBUFS) * WSLICE, w_all, c0, c_in, c_out, o0, vec_w, tid);
    }
    cp_async_commit();
  };

  // Per-lane fragment offsets.  A (a tap's slice): m-tile mi, this k-group's
  // k-step.  ldmatrix.x4 matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7,
  // k 8-15), (m 8-15, k 8-15); lane l gives row l & 7 of matrix l >> 3.
  int a_off[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (FLIP) {  // rows are k: row 16kg + 8(l >> 4) + (l & 7), m at 16mi + 8((l >> 3) & 1)
      const int k = 16 * kg + 8 * (lane >> 4) + (lane & 7);
      a_off[mi] = wall_at(k, 16 * mi + 8 * ((lane >> 3) & 1));
    } else {     // rows are m: row 16mi + (l & 15), k at 16kg + 8(l >> 4)
      a_off[mi] = wall_at(16 * mi + (lane & 15), 16 * kg + 8 * (lane >> 4));
    }
  }
  // B: this warp's n-tiles are wn + WN*j, j < nvalid; pair p is j = 2p and
  // 2p+1: lane l gives pixel l & 7 of n-tile 2p + (l >> 4), channels 8((l >>
  // 3) & 1) of the k-step.  boff[p]: that pixel's tap (0, 0) in xs (lanes
  // past the tile read pixel lane & 7 of the first n-tile, or 0, in banks
  // of their own; their sums are not stored).
  const int nvalid = wn < g.nt ? (g.nt - wn + WN - 1) / WN : 0;
  int boff[NTW / 2];
#pragma unroll
  for (int p = 0; p < NTW / 2; ++p) {
    int q = (wn + WN * (2 * p + (lane >> 4))) * 8 + (lane & 7);
    if (q >= g.npix) q = (lane & 7) < g.npix ? lane & 7 : 0;
    const int r = (int)(((unsigned)q * (unsigned)g.wd_mul) >> WD_SHIFT);
    boff[p] = (r * g.swp + q - r * g.wd) * CP + 16 * kg + 8 * ((lane >> 3) & 1);
  }

  float acc[2][NTW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  if (g.vec_x) zero_side_columns<THREADS>(xs, g.rows + 2, g.swp, W, tid);
  issue(0);
  issue(1);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_prior();
    __syncthreads();  // stage s has landed; the block is done with xs
    if (g.vec_x)
      turn_run<WARPS>(xs, land_of(s), run, W, g.swp, g.lpc, g.wd_mul, warp, lane);
    else
      stage_band<THREADS>(xs, xn + s * CG * L, c_in - s * CG, y0, x0, g.rows, g.wd, g.swp, H,
                          W, tid);
    __syncthreads();  // xs holds stage s; its landing buffer is free
    issue(s + 2);

    const bf16* wsl = wbuf + (s % WBUFS) * WSLICE;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (FLIP)
          ldmatrix_x4_trans(a[mi], wsl + t * 32 * WROW + a_off[mi]);
        else
          ldmatrix_x4(a[mi], wsl + t * 32 * WROW + a_off[mi]);
      }
      const bf16* xt = xs + ((t / 3) * g.swp + t % 3) * CP;
#pragma unroll
      for (int p = 0; p < NTW / 2; ++p) {
        if (2 * p < nvalid) {
          uint32_t bb[4];
          ldmatrix_x4(bb, xt + boff[p]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_acc(acc[mi][2 * p], a[mi], bb[0], bb[1]);
          if (2 * p + 1 < nvalid) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_acc(acc[mi][2 * p + 1], a[mi], bb[2], bb[3]);
          }
        }
      }
    }
  }

  // The second k-group's sums through the wall buffers (every copy has
  // landed: the groups committed after the last stage are empty), added by
  // the first in a fixed order.  acc[mi][j]: output channels 16mi + gq (e <
  // 2) and + 8 (e >= 2) of the block, pixels 2q and 2q+1 of n-tile wn + WN*j
  // (the m16n8 accumulator layout).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem) + wn * (NTW * 2 * 4 * 32) + lane;
  if (kg == 1) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if (j < nvalid)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((j * 2 + mi) * 4 + e) * 32] = acc[mi][j][e];
  }
  __syncthreads();
  if (kg == 1) return;
  const int gq = lane >> 2, q = lane & 3;
  const int rv = min(g.rows, H - y0);  // rows of the tile inside the image
  const bool pairs = g.vec_x && (y0 * W) % 2 == 0;  // 4-byte aligned bf16 pairs
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j >= nvalid) continue;
    const int tp = (wn + WN * j) * 8 + 2 * q;  // the pair's first pixel of the tile
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + 16 * mi + gq + 8 * h;
        if (o >= c_out) continue;
        const float v0 = acc[mi][j][2 * h] + red[((j * 2 + mi) * 4 + 2 * h) * 32];
        const float v1 = acc[mi][j][2 * h + 1] + red[((j * 2 + mi) * 4 + 2 * h + 1) * 32];
        bf16* on = outn + o * L;
        if (g.vec_x) {  // the tile's rows are the plane's pixels y0*W ..
          const int lim = rv * W;
          const int at = y0 * W + tp;
          if (pairs && tp + 1 < lim) {
            *reinterpret_cast<__nv_bfloat162*>(on + at) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (tp < lim) on[at] = __float2bfloat16_rn(v0);
            if (tp + 1 < lim) on[at + 1] = __float2bfloat16_rn(v1);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pq = tp + e;
            const int r = (int)(((unsigned)pq * (unsigned)g.wd_mul) >> WD_SHIFT);
            const int xx = pq - r * g.wd;
            if (pq < g.npix && r < rv && x0 + xx < W)
              on[(y0 + r) * W + x0 + xx] = __float2bfloat16_rn(e ? v1 : v0);
          }
        }
      }
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

template <bool FLIP>
cudaError_t launch_flip(const bf16* x, const bf16* w_all, bf16* out, int c_in, int c_out,
                        int h, int w, const Geometry& g, int vec_w, cudaStream_t stream) {
  const cudaError_t err = allow_smem<conv3x3_nl_mma_kernel<FLIP>>();
  if (err != cudaSuccess) return err;
  conv3x3_nl_mma_kernel<FLIP><<<dim3(g.tiles, g.mz), THREADS, g.smem, stream>>>(
      x, w_all, out, c_in, c_out, h, w, g, vec_w);
  return cudaGetLastError();
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
                   int h, int w, int flip, cudaStream_t stream) {
  const Geometry g = geometry(n, c_out, h, w, aligned(x) && aligned(out));
  if (g.smem > SMEM_MOST || g.tiles < 1) return cudaErrorInvalidConfiguration;
  const int vec_w = (flip ? c_out : c_in) % 8 == 0 && aligned(w_all);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w_all);
  bf16* op = static_cast<bf16*>(out);
  if (flip) return launch_flip<true>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream);
  return launch_flip<false>(xp, wp, op, c_in, c_out, h, w, g, vec_w, stream);
}

// ---------------------------------------------------------------------------
// K5dw in bf16: tensor cores (see the note at the top).

namespace cg = cooperative_groups;

constexpr int DW_WARPS = 6;                // 3 kernel rows x 2 m-tiles
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_C = 32;                   // input and output channels of a block's tile
constexpr int DW_MAX_PIX = 256;            // most pixels of a band
constexpr int DW_BUFS = 3;                 // dy buffers in flight or in use
constexpr int DW_CLUSTER = 2;              // most blocks of a cluster (see the note at the top)
constexpr int DW_RS = DW_C + 8;            // floats a row of the sums: float2 stores, no conflicts
constexpr int DW_RED_BYTES = 9 * DW_C * DW_RS * 4;
static_assert(DW_C == CG, "x lands as K5 lands it, 32 channel rows a piece");

// How a K5dw launch is cut.  A unit is a band of `rows` rows of a window of
// `wd` columns of one image (wd == W unless rows are too wide to stage):
// `ncw` windows across a row, `bands` down the image, `units` in all.  A
// tile is 32 input x 32 output channels (`ig` tiles across C_in, `tiles` in
// all: grid.y); the `slabs` blocks of a tile (grid.x) take `slab` units
// each, in clusters of `cl` blocks whose sums go to one of `slots`
// workspace slots.  vec: x and dy land by cp.async (as Geometry's vec_x);
// swp, lpc, wd_mul as in Geometry.  dy lands in DW_BUFS buffers of 32
// channel rows of `lpd` 16-byte pieces (odd; the first 2 * ceil(rows * wd /
// 16) hold the band's k-steps).  Shared memory: the dy buffers, the pixel
// tile xs at xs_off and two x landing buffers at land_off, or at the end
// the block's sums (DW_RED_BYTES).
struct DwGeometry {
  int ig, tiles, wd, ncw, rows, bands, units, slab, slabs, cl, slots;
  int vec, swp, lpc, lpd, wd_mul;
  int dy_bytes, xs_off, land_off, land_bytes, smem;  // bytes
};

void dw_layout(DwGeometry& g, int W) {
  const int r2 = g.rows + 2;
  g.swp = tile_pitch(g.wd);
  g.lpd = 2 * ceil_div(g.rows * g.wd, 16) + 1;
  g.dy_bytes = DW_C * g.lpd * 16;
  g.xs_off = DW_BUFS * g.dy_bytes;
  g.land_off = g.xs_off + r2 * g.swp * CP * 2;
  g.lpc = g.vec ? run_pitch(g.rows, W) : 0;
  g.land_bytes = CG * g.lpc * 16;
  g.smem = g.land_off + 2 * g.land_bytes;
  if (g.smem < DW_RED_BYTES) g.smem = DW_RED_BYTES;
  g.wd_mul = (1 << WD_SHIFT) / g.wd + 1;  // exact for q * wd < 2^20
}

// The cut that gives the busiest block the least work (its units' k-steps,
// plus a share for each unit's halo and set-up), over band heights that
// fit shared memory and, where x and dy land by cp.async, start every band
// at a 16-byte piece of the plane (a multiple of 8 / gcd(W, 8) rows, or the
// whole image); element-wise staging where no such band fits.  The grid is
// one wave of two blocks an SM.  Shapes and alignment only, so the
// summation order is the same on every card.  slabs == 0: no cut fits.
DwGeometry dw_geometry(int n, int c_in, int c_out, int h, int w, bool aligned_xy) {
  DwGeometry best{};
  long long best_cost = -1;
  const int ig = ceil_div(c_in, DW_C);
  const int tiles = ig * ceil_div(c_out, DW_C);
  const int target = tiles >= 2 * SMS ? 1 : 2 * SMS / tiles;
  for (int vec = aligned_xy && (long long)h * w % 8 == 0; vec >= 0 && best_cost < 0; --vec) {
    DwGeometry g{};
    g.ig = ig;
    g.tiles = tiles;
    g.vec = vec;
    g.ncw = vec || w <= MAX_WIN ? 1 : ceil_div(w, MAX_WIN);
    g.wd = ceil_div(w, g.ncw);
    const int unit_rows = vec ? 8 / (w % 8 == 0 ? 8 : w % 4 == 0 ? 4 : w % 2 == 0 ? 2 : 1) : 1;
    for (int k = 1;; ++k) {
      g.rows = k * unit_rows < h ? k * unit_rows : h;
      if (g.rows * g.wd > DW_MAX_PIX) break;
      dw_layout(g, w);
      g.bands = ceil_div(h, g.rows);
      const long long units = (long long)n * g.bands * g.ncw;
      if (g.smem <= SMEM_MOST && units <= 0x7fffffffLL) {
        g.units = (int)units;
        const int s0 = g.units < target ? g.units : target;
        g.cl = 1;
        while (2 * g.cl <= s0 && 2 * g.cl <= DW_CLUSTER) g.cl *= 2;
        g.slab = ceil_div(g.units, s0 / g.cl * g.cl);
        g.slabs = ceil_div(ceil_div(g.units, g.slab), g.cl) * g.cl;
        g.slots = g.slabs / g.cl;
        const long long cost =
            (long long)g.slab * (ceil_div(g.rows * g.wd, 16) * 16 + g.wd / 2 + 64);
        if (best_cost < 0 || cost < best_cost) {
          best = g;
          best_cost = cost;
        }
      }
      if (g.rows == h) break;
    }
  }
  return best;
}

// Grid (slabs, tiles) in clusters of g.cl blocks along x; DW_THREADS
// threads, at most 128 registers each (two blocks an SM).  Block (z, tile)
// sums its tile of dw over units [z * slab, min(units, (z+1) * slab)); the
// blocks of a cluster add their sums into slot z / cl of ws, (9*c_in,
// c_out) floats a slot, row t*c_in + i.
__global__ void __maxnreg__(128)
conv3x3_nl_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                         float* __restrict__ ws, int c_in, int c_out, int H, int W,
                         DwGeometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ki = warp >> 1, mh = warp & 1;  // kernel row, m-tile (16 input channels)
  const int i0 = (blockIdx.y % g.ig) * DW_C, o0 = (blockIdx.y / g.ig) * DW_C;
  const int L = H * W;  // offsets inside one image fit 32 bits (valid())
  const int u0 = blockIdx.x * g.slab;
  const int stages = max(0, min(g.units - u0, g.slab));
  const int per_image = g.bands * g.ncw;
  const int npix = g.rows * g.wd;

  // unit u0 + s: its image and the first row and column of its band
  auto unit = [&](int s, int& img, int& y0, int& x0) {
    const int u = u0 + s;
    img = u / per_image;
    const int b = u - img * per_image;
    const int band = b / g.ncw;
    y0 = band * g.rows;
    x0 = (b - band * g.ncw) * g.wd;
  };
  auto dy_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % DW_BUFS) * g.dy_bytes);
  };
  auto land_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + g.land_off + (s & 1) * g.land_bytes);
  };
  // vec: unit s's x band (land_run) and its dy band (pieces of the plane's
  // pixels from y0*W, zero past the band or the plane; warp w lands channel
  // rows w, w+6, ..., lanes walk the pieces): one commit group, empty past
  // the last unit and for element-wise staging.
  auto issue = [&](int s) {
    if (g.vec && s < stages) {
      int img, y0, x0;
      unit(s, img, y0, x0);
      const bf16* dn = dy + ((long long)img * c_out + o0) * L;
      land_run<DW_WARPS>(land_of(s), x + ((long long)img * c_in + i0) * L, c_in - i0,
                         band_run(y0, g.rows, W), L, g.lpc, warp, lane);
      bf16* dl = dy_of(s);
      for (int j = lane; j < g.lpd - 1; j += 32) {
        const int p = y0 * W + 8 * j;
        const bool in = 8 * j < npix && p < L;
        for (int ch = warp; ch < DW_C; ch += DW_WARPS) {
          const bool v = in && o0 + ch < c_out;
          cp_async16(dl + (ch * g.lpd + j) * 8, v ? dn + ch * L + p : dy, v ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // A (x at one tap; ldmatrix.x4.trans, rows are pixels): lane l gives pixel
  // jl = (l & 7) + 8(l >> 4) of the k-step, input channels a_ch .. +7 (the
  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k
  // 8-15)).  B (dy; ldmatrix.x4, rows are output channels): lane l gives
  // channel jl of n-tiles 0-1 (+16: n-tiles 2-3), pixels 8((l >> 3) & 1) ..
  // +7 of the k-step.
  const int jl = (lane & 7) + 8 * (lane >> 4);
  const int a_ch = 16 * mh + 8 * ((lane >> 3) & 1);
  const int b_off = (jl * g.lpd + ((lane >> 3) & 1)) * 8;

  float acc[3][4][4];
#pragma unroll
  for (int kj = 0; kj < 3; ++kj)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kj][nt][e] = 0.f;

  if (g.vec) zero_side_columns<DW_THREADS>(xs, g.rows + 2, g.swp, W, tid);
  issue(0);
  issue(1);
  for (int s = 0; s < stages; ++s) {
    int img, y0, x0;
    unit(s, img, y0, x0);
    bf16* dl = dy_of(s);
    cp_async_wait_prior();
    __syncthreads();  // unit s has landed; the block is done with xs and unit s-1's dy
    if (g.vec) {
      turn_run<DW_WARPS>(xs, land_of(s), band_run(y0, g.rows, W), W, g.swp, g.lpc, g.wd_mul,
                         warp, lane);
    } else {
      stage_band<DW_THREADS>(xs, x + ((long long)img * c_in + i0) * L, c_in - i0, y0, x0,
                             g.rows, g.wd, g.swp, H, W, tid);
      const bf16* dn = dy + ((long long)img * c_out + o0) * L;
      const bf16 zero = __float2bfloat16_rn(0.f);
      const int nd = (g.lpd - 1) * 8;
      for (int e = tid; e < DW_C * nd; e += DW_THREADS) {
        const int j = e % nd, ch = e / nd;
        const int r = j / g.wd, sc = j - r * g.wd;
        const bool in = o0 + ch < c_out && j < npix && y0 + r < H && x0 + sc < W;
        dl[ch * g.lpd * 8 + j] = in ? dn[ch * L + (y0 + r) * W + x0 + sc] : zero;
      }
    }
    __syncthreads();  // xs holds unit s; its landing buffer is free
    issue(s + 2);

    // k-steps of 16 of the band's pixels j (row-major in the band) that lie
    // in the image; a lane's pixel past the band reads pixel (l & 7) or 0 of
    // x (distinct rows for the ldmatrix) against dy's zeros
    const int nks = (min(g.rows, H - y0) * g.wd + 15) / 16;
    for (int ks = 0; ks < nks; ++ks) {
      int j = 16 * ks + jl;
      if (j >= npix) j = (lane & 7) < npix ? lane & 7 : 0;
      const int r = (int)(((unsigned)j * (unsigned)g.wd_mul) >> WD_SHIFT);
      const bf16* xa = xs + ((r + ki) * g.swp + j - r * g.wd) * CP + a_ch;
      uint32_t b0[4], b1[4];
      ldmatrix_x4(b0, dl + b_off + 16 * ks);
      ldmatrix_x4(b1, dl + b_off + 16 * ks + 16 * g.lpd * 8);
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, xa + kj * CP);
        mma_acc(acc[kj][0], a, b0[0], b0[1]);
        mma_acc(acc[kj][1], a, b0[2], b0[3]);
        mma_acc(acc[kj][2], a, b1[0], b1[1]);
        mma_acc(acc[kj][3], a, b1[2], b1[3]);
      }
    }
  }

  // The block's sums into shared memory (every copy has landed: the groups
  // committed after the last unit are empty), rows (t, i) of the tile:
  // acc[kj][nt]: tap 3ki + kj, input channels 16mh + gq (e < 2) and + 8 (e
  // >= 2), output channels 8nt + 2q + (e & 1) (the m16n8 accumulator
  // layout).  Then block `rank` of the cluster adds rows [rank * part, (rank
  // + 1) * part) of the tile over the cluster's blocks in rank order,
  // through distributed shared memory, and stores them in the slot.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  {
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int kj = 0; kj < 3; ++kj)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              red + ((3 * ki + kj) * DW_C + 16 * mh + gq + 8 * h) * DW_RS + 8 * nt + 2 * q) =
              make_float2(acc[kj][nt][2 * h], acc[kj][nt][2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster holds its sums
  const int rank = (int)cluster.block_rank();
  const int part = 9 * DW_C / g.cl;
  float* slot = ws + (long long)(blockIdx.x / g.cl) * 9 * c_in * c_out;
  for (int e = tid; e < part * (DW_C / 4); e += DW_THREADS) {
    const int row = rank * part + e / (DW_C / 4), col = 4 * (e % (DW_C / 4));
    float4 v[DW_CLUSTER];
#pragma unroll
    for (int k = 0; k < DW_CLUSTER; ++k)
      if (k < g.cl)
        v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, k) + row * DW_RS +
                                                col);
    float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int k = 1; k < DW_CLUSTER; ++k)
      if (k < g.cl) {
        sum[0] += v[k].x;
        sum[1] += v[k].y;
        sum[2] += v[k].z;
        sum[3] += v[k].w;
      }
    const int t = row / DW_C, i = i0 + row % DW_C;
    if (i < c_in)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (o0 + col + c < c_out) slot[((long long)t * c_in + i) * c_out + o0 + col + c] = sum[c];
  }
  cluster.sync();  // the other blocks have read this block's sums
}

cudaError_t launch_dw(const void* x, const void* dy, float* ws, float* out, int n, int c_in,
                      int c_out, int h, int w, cudaStream_t stream) {
  const DwGeometry g = dw_geometry(n, c_in, c_out, h, w, aligned(x) && aligned(dy));
  if (g.slabs < 1 || g.tiles > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = allow_smem<conv3x3_nl_dw_mma_kernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.slabs, g.tiles);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = g.cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv3x3_nl_dw_mma_kernel, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(dy), g.slots > 1 ? ws : out, c_in, c_out,
                           h, w, g);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || g.slots == 1) return err;
  return launch_dw_reduce(ws, out, g.slots, c_in, c_out, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// x: (n, c_in, h*w), out: (n, c_out, h*w), w_all: (c_out, 9*c_in) tap-major
// (flip = 0), or the forward's wall (c_in, 9*c_out) read flipped and
// transposed (flip = 1: the input gradient of that forward), all contiguous
// on the current device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// bf16 runs on the tensor cores, f32 on the CUDA cores.  Returns a
// cudaError_t as int.
int conv3x3_nl(const void* x, const void* w_all, void* out, int n, int c_in, int c_out,
               int h, int w, int flip, int is_bf16, void* stream) {
  if (!valid(n, c_in, c_out, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? tc::launch(x, w_all, out, n, c_in, c_out, h, w, flip, s)
              : launch_fwd_f32(x, w_all, out, n, c_in, c_out, h, w, flip, s);
  return static_cast<int>(err);
}

// Floats of workspace conv3x3_nl_dw needs for these shapes in either dtype
// (0 if invalid): the most slots of the f32 route and of the bf16 route,
// staged either way.
long long conv3x3_nl_dw_workspace(int n, int c_in, int c_out, int h, int w) {
  if (!valid(n, c_in, c_out, h, w)) return 0;
  long long parts = slabs(n, c_in, c_out, h, w).parts;
  for (int aligned_xy = 0; aligned_xy < 2; ++aligned_xy) {
    const int slots = tc::dw_geometry(n, c_in, c_out, h, w, aligned_xy).slots;
    if (slots > parts) parts = slots;
  }
  return parts * 9 * c_in * c_out;
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
      is_bf16 ? tc::launch_dw(x, dy, wsp, op, n, c_in, c_out, h, w, s)
              : launch_dw_f32(x, dy, wsp, op, n, c_in, c_out, h, w, s);
  return static_cast<int>(err);
}

const char* conv3x3_nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
