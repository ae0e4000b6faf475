// Streaming SAD block matching for rectified stereo pairs on Hopper (sm_90a).
//
// Replaces the TPU kernel `_bm_kernel` of d2slam_tpu/ops/stereo_bm_pallas.py
// (launched by `block_match_disparity_pallas`). Per pixel, over the
// disparities d in [0, D): the absolute difference of the left image and
// the right image shifted by d (circularly in x), a BLOCK x BLOCK box mean
// (rows replicated above and below the image, columns circular), the cost
// 1e3 on columns without a match, and a running best cost / best disparity,
// the second-best cost outside the winner's +-1 neighbourhood, and the
// costs at the winner's two neighbours, from which the sub-pixel parabola
// is evaluated after the loop. Only the four [H, W] outputs reach device
// memory; the [D, H, W] cost volume never exists.
//
// Bound on the card: 8 bytes read and 16 written per pixel against roughly
// (2*BLOCK + 10) non-fused f32 / integer instructions per pixel and
// disparity, so the kernel is bound by operations, not by bytes (see
// ops/stereo_bm.py: bm_ops, bm_bytes). What stands between a kernel and
// that bound is the SM's shared-memory pipe (it takes one warp-wide
// instruction per clock where the ALUs take four) and, at the four pairs
// of a quadcam frame, too few warps to hide latencies: the design spends
// few shared-memory instructions per pixel and disparity and keeps the
// registers of a thread low, so that many small blocks fit an SM.
//
// Design. One thread block per (image, tile of PY = 4 rows, tile of TC
// columns, TC a multiple of 4 that the caller chooses from W). Per
// disparity the block works in two stages with two mappings of threads
// to pixels, handing the vertical sums over through shared memory:
//   1. Vertical stage, one thread per column of the tile (the R halo
//      columns on each side included). The thread's PY + 2R left-image
//      values live in registers for the whole loop; the right-image tile,
//      widened by the D - 1 columns the shift reaches, lives in shared
//      memory, so the shift by d is an index offset. The thread forms its
//      PY + 2R absolute differences once, sums them vertically for its PY
//      rows and stores the PY sums (conflict-free 4-byte stores).
//   2. Horizontal stage, one thread per (row, group of 4 adjacent
//      columns). It reads the 4 + 2R vertical sums its 4 pixels need with
//      16-byte loads (3 loads at BLOCK 9, where one thread per pixel would
//      need 36 scalar ones), sums 2R + 1 neighbours per pixel in
//      registers and updates the 4 pixels' running values, which never
//      leave registers. The eight threads of a 16-byte load phase read
//      four rows of two groups; the row pitch is 8 mod 32 words, so they
//      hit distinct banks.
// One __syncthreads() per disparity, through a double-buffered sum array.
// The TPU kernel's row bands and lane rolls have no counterpart. The
// summation order is the TPU kernel's (rows ascending; columns 0, -1, +1,
// -2, +2, ...) and the file is compiled with -fmad=false, so a cost equals
// the plain version's bit for bit and near-ties pick the same winner.
#include <cuda_runtime.h>

namespace {

constexpr int PY = 4;             // rows of a tile
constexpr int CX = 4;             // adjacent columns of a horizontal-stage thread
constexpr int MAX_THREADS = 128;  // columns of a tile, halo included
constexpr float BIG = 1e9f;

__host__ __device__ constexpr int halo_of(int r) { return (r + 3) / 4 * 4; }

// The eight threads of one 16-byte load phase are PY rows x 8 / PY column
// groups; a pitch of 4 * (8 / PY) mod 32 words puts them on distinct banks.
constexpr int POFF = 8 / PY * 4;
__host__ __device__ constexpr int pitch_of(int n) { return (n - POFF + 31) / 32 * 32 + POFF; }

__device__ __forceinline__ int wrap(int a, int W) {
  a %= W;
  return a < 0 ? a + W : a;
}

template <int BLOCK>
__global__ void __launch_bounds__(MAX_THREADS)
bm_kernel(const float* __restrict__ left, const float* __restrict__ right,
          float* __restrict__ disp, int* __restrict__ best,
          float* __restrict__ cost, float* __restrict__ second,
          int H, int W, int D, int TC, int reverse) {
  constexpr int R = BLOCK / 2;
  constexpr int HALO = halo_of(R);   // R rounded up to whole 16-byte loads
  constexpr int ROWS = PY + 2 * R;
  constexpr int NW = CX + 2 * HALO;  // window of vertical sums a thread loads
  extern __shared__ __align__(16) float smem[];
  const int TW = TC + 2 * R;         // columns of the vertical stage
  const int WS = TW + D - 1;         // columns of the right-image tile
  const int PITCH = pitch_of(TC + 2 * HALO);
  float* Rs = smem;                                // [ROWS][WS]
  float* vs = smem + (ROWS * WS + 3) / 4 * 4;      // [2][PY][PITCH]

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TC;
  const int y0 = blockIdx.y * PY;
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* L = left + img;
  const float* Rg = right + img;

  // right tile: shared column s holds image column (gbase + s) mod W
  const int gbase = x0 - R - (reverse ? 0 : D - 1);
  for (int s = t; s < WS; s += blockDim.x) {
    const int xw = wrap(gbase + s, W);  // one modulo a column, none a pixel
#pragma unroll
    for (int row = 0; row < ROWS; ++row) {
      const int y = min(max(y0 - R + row, 0), H - 1);
      Rs[row * WS + s] = Rg[(size_t)y * W + xw];
    }
  }
  // vertical stage: this thread's left column, rows replicated at the
  // image's edges
  const bool vert = t < TW;
  float Lc[ROWS];
  {
    const int xg = wrap(x0 - R + t, W);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int y = min(max(y0 - R + i, 0), H - 1);
      Lc[i] = vert ? L[(size_t)y * W + xg] : 0.f;
    }
  }
  __syncthreads();

  // horizontal stage: row j, columns x .. x + CX - 1
  const int j = t % PY;
  const int g = t / PY;
  const int x = x0 + CX * g;
  const bool horiz = CX * g < TC && x < W;
  // most warps own no pixel that ever lacks a match: they skip the mask
  const bool can_lack = reverse ? x + CX - 1 >= W - (D - 1) : x < D - 1;
  const bool warp_masks = __any_sync(0xffffffffu, horiz && can_lack);
  const float inv = (float)(1.0 / (BLOCK * BLOCK));

  float best_c[CX], second_c[CX], cm1[CX], cp1[CX], c_prev[CX];
  int best_d[CX];
#pragma unroll
  for (int i = 0; i < CX; ++i) {
    best_c[i] = second_c[i] = cm1[i] = cp1[i] = c_prev[i] = BIG;
    best_d[i] = -2;
  }

  for (int d = 0; d < D; ++d) {
    float* vb = vs + (d & 1) * (PY * PITCH);
    if (vert) {
      const int scol = reverse ? t + d : t + (D - 1) - d;
      float sad[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) sad[i] = fabsf(Lc[i] - Rs[i * WS + scol]);
      // sum array column s stands for tile column s - HALO
      float* col = vb + t + (HALO - R);
#pragma unroll
      for (int jj = 0; jj < PY; ++jj) {
        float v = sad[jj];
#pragma unroll
        for (int dy = 1; dy < BLOCK; ++dy) v = v + sad[jj + dy];
        col[jj * PITCH] = v;
      }
    }
    // one barrier per step: the next step writes the other buffer, and the
    // step after that is behind the next barrier
    __syncthreads();
    if (horiz) {
      const float4* row = reinterpret_cast<const float4*>(vb + j * PITCH + CX * g);
      float w[NW];
#pragma unroll
      for (int k = 0; k < NW / 4; ++k) {
        const float4 q = row[k];
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
      float c[CX];
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        float hs = w[HALO + i];
#pragma unroll
        for (int dx = 1; dx <= R; ++dx) {
          hs = hs + w[HALO + i - dx];
          hs = hs + w[HALO + i + dx];
        }
        c[i] = hs * inv;
      }
      if (warp_masks) {
#pragma unroll
        for (int i = 0; i < CX; ++i) {
          const bool invalid = reverse ? (x + i >= W - d) : (x + i < d);
          if (invalid) c[i] = 1e3f;
        }
      }
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const float bc = best_c[i];
        const bool take = c[i] < bc;  // strict: the lowest d wins a tie
        // best_d is an earlier disparity (or -2): it is the step before
        // or further off, never nearer
        if (best_d[i] == d - 1)
          cp1[i] = c[i];
        else
          second_c[i] = fminf(second_c[i], take ? bc : c[i]);
        if (take) {
          cm1[i] = c_prev[i];
          best_c[i] = c[i];
          best_d[i] = d;
        }
        c_prev[i] = c[i];
      }
    }
  }

  const int y = y0 + j;
  if (!horiz || y >= H) return;
#pragma unroll
  for (int i = 0; i < CX; ++i) {
    if (x + i >= W) break;
    // cp1 was written one step after every new winner; a winner at the
    // last step has no next cost
    if (best_d[i] == D - 1) cp1[i] = BIG;
    const bool have_nb = cm1[i] < 0.5f * BIG && cp1[i] < 0.5f * BIG;
    const float denom = fmaxf(cm1[i] - 2.0f * best_c[i] + cp1[i], 1e-6f);
    const float delta =
        fminf(fmaxf(0.5f * (cm1[i] - cp1[i]) / denom, -1.0f), 1.0f);
    const size_t o = img + (size_t)y * W + x + i;
    disp[o] = (float)best_d[i] + (have_nb ? delta : 0.0f);
    best[o] = best_d[i];
    cost[o] = best_c[i];
    second[o] = second_c[i];
  }
}

template <int BLOCK>
cudaError_t launch(const float* left, const float* right, float* disp,
                   int* best, float* cost, float* second, int N, int H, int W,
                   int D, int TC, int reverse, cudaStream_t stream) {
  constexpr int R = BLOCK / 2;
  const int TW = TC + 2 * R;
  if (TC < CX || TC % CX || TW > MAX_THREADS) return cudaErrorInvalidValue;
  const int need = TW > PY * (TC / CX) ? TW : PY * (TC / CX);
  if (need > MAX_THREADS) return cudaErrorInvalidValue;
  const int threads = (need + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * ((size_t)((PY + 2 * R) * (TW + D - 1) + 3) / 4 * 4 +
                       (size_t)2 * PY * pitch_of(TC + 2 * halo_of(R)));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bm_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TC - 1) / TC, (H + PY - 1) / PY, N);
  bm_kernel<BLOCK><<<grid, threads, smem, stream>>>(
      left, right, disp, best, cost, second, H, W, D, TC, reverse);
  return cudaGetLastError();
}

}  // namespace

// left, right: [N, H, W] f32 contiguous. disp, cost, second: [N, H, W] f32;
// best: [N, H, W] i32. block: odd, 1..15. tile_cols: the columns of a tile
// (the caller's choice): a multiple of 4 with tile_cols + block - 1 <=
// 128. Returns the CUDA error code of the launch (0 = launched); does not
// synchronise.
extern "C" int stereo_bm_launch(const void* left, const void* right,
                                void* disp, void* best, void* cost,
                                void* second, int N, int H, int W, int D,
                                int block, int tile_cols, int reverse,
                                void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || D < 1 ||
      (H + PY - 1) / PY > 65535)
    return (int)cudaErrorInvalidValue;
#define BM_CASE(B)                                                          \
  case B:                                                                   \
    return (int)launch<B>((const float*)left, (const float*)right,          \
                          (float*)disp, (int*)best, (float*)cost,           \
                          (float*)second, N, H, W, D, tile_cols, reverse,   \
                          (cudaStream_t)stream);
  switch (block) {
    BM_CASE(1)
    BM_CASE(3)
    BM_CASE(5)
    BM_CASE(7)
    BM_CASE(9)
    BM_CASE(11)
    BM_CASE(13)
    BM_CASE(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BM_CASE
}
