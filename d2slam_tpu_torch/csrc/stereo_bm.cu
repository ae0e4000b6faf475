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
// (2*BLOCK + 17) non-fused f32 / integer instructions per pixel and
// disparity, so the kernel is bound by operations, not by bytes (see
// ops/stereo_bm.py: bm_ops, bm_bytes).
//
// Design. One thread block per (image, tile of PY rows, tile of TC
// columns). A thread stands for one column of the tile, the R halo columns
// on each side included, and owns the PY pixels of that column:
//   * its PY + 2R left-image values live in registers for the whole loop;
//   * the right-image tile, widened by the D - 1 columns the shift reaches,
//     lives in shared memory, so the shift by d is an index offset;
//   * per d the thread forms the PY + 2R absolute differences once, sums
//     them vertically for its PY rows and writes the sums to a
//     double-buffered shared array; after one __syncthreads() each owner
//     sums 2R + 1 neighbouring columns and updates its running values,
//     which stay in registers.
// The TPU kernel's row bands and lane rolls have no counterpart. The
// summation order is the TPU kernel's (rows ascending; columns 0, -1, +1,
// -2, +2, ...) and the file is compiled with -fmad=false, so a cost equals
// the plain version's bit for bit and near-ties pick the same winner.
#include <cuda_runtime.h>

namespace {

constexpr int PY = 8;             // rows owned by one thread
constexpr int MAX_THREADS = 128;  // columns of a tile, halo included
constexpr float BIG = 1e9f;

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
  constexpr int ROWS = PY + 2 * R;
  extern __shared__ float smem[];
  const int TW = TC + 2 * R;     // columns of the vertical sums (= threads)
  const int WS = TW + D - 1;     // columns of the right-image tile
  float* Rs = smem;              // [ROWS][WS]
  float* vs = smem + ROWS * WS;  // [2][PY][TW]

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TC;
  const int y0 = blockIdx.y * PY;
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* L = left + img;
  const float* Rg = right + img;

  // right tile: shared column s holds image column (gbase + s) mod W
  const int gbase = x0 - R - (reverse ? 0 : D - 1);
  for (int idx = t; idx < ROWS * WS; idx += blockDim.x) {
    const int row = idx / WS;
    const int s = idx - row * WS;
    const int y = min(max(y0 - R + row, 0), H - 1);
    Rs[idx] = Rg[(size_t)y * W + wrap(gbase + s, W)];
  }
  // this thread's left column, rows replicated at the image's edges
  const int xg = wrap(x0 - R + t, W);
  float Lc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = min(max(y0 - R + i, 0), H - 1);
    Lc[i] = L[(size_t)y * W + xg];
  }
  __syncthreads();

  const int x = x0 + t - R;  // the owned column (halo threads own none)
  const bool owner = t >= R && t < R + TC && x < W;
  const float inv = (float)(1.0 / (BLOCK * BLOCK));

  float best_c[PY], second_c[PY], cm1[PY], cp1[PY], c_prev[PY];
  int best_d[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    best_c[j] = second_c[j] = cm1[j] = cp1[j] = c_prev[j] = BIG;
    best_d[j] = -2;
  }

  for (int d = 0; d < D; ++d) {
    const int scol = reverse ? t + d : t + (D - 1) - d;
    float sad[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sad[i] = fabsf(Lc[i] - Rs[i * WS + scol]);
    float* vb = vs + (d & 1) * PY * TW;
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      float v = sad[j];
#pragma unroll
      for (int dy = 1; dy < BLOCK; ++dy) v = v + sad[j + dy];
      vb[j * TW + t] = v;
    }
    // one barrier per step: the next step writes the other buffer, and the
    // step after that is behind the next barrier
    __syncthreads();
    if (owner) {
      const bool invalid = reverse ? (x >= W - d) : (x < d);
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        const float* row = vb + j * TW + t;
        float hs = row[0];
#pragma unroll
        for (int dx = 1; dx <= R; ++dx) {
          hs = hs + row[-dx];
          hs = hs + row[dx];
        }
        float c = hs * inv;
        if (invalid) c = 1e3f;

        const float bc = best_c[j];
        const int bd = best_d[j];
        const bool take = c < bc;  // strict: the lowest d wins a tie
        const bool far_old = abs(bd - d) > 1;
        cm1[j] = take ? c_prev[j] : cm1[j];
        cp1[j] = take ? BIG : (bd + 1 == d ? c : cp1[j]);
        if (far_old) second_c[j] = fminf(second_c[j], take ? bc : c);
        best_c[j] = take ? c : bc;
        best_d[j] = take ? d : bd;
        c_prev[j] = c;
      }
    }
  }

  if (!owner) return;
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    const int y = y0 + j;
    if (y >= H) break;
    const bool have_nb = cm1[j] < 0.5f * BIG && cp1[j] < 0.5f * BIG;
    const float denom = fmaxf(cm1[j] - 2.0f * best_c[j] + cp1[j], 1e-6f);
    const float delta =
        fminf(fmaxf(0.5f * (cm1[j] - cp1[j]) / denom, -1.0f), 1.0f);
    const size_t o = img + (size_t)y * W + x;
    disp[o] = (float)best_d[j] + (have_nb ? delta : 0.0f);
    best[o] = best_d[j];
    cost[o] = best_c[j];
    second[o] = second_c[j];
  }
}

template <int BLOCK>
cudaError_t launch(const float* left, const float* right, float* disp,
                   int* best, float* cost, float* second, int N, int H, int W,
                   int D, int reverse, cudaStream_t stream) {
  constexpr int R = BLOCK / 2;
  // column tiles of equal width, each at most MAX_THREADS - 2R wide
  const int max_tc = MAX_THREADS - 2 * R;
  const int n_tiles = (W + max_tc - 1) / max_tc;
  const int TC = (W + n_tiles - 1) / n_tiles;
  const int TW = TC + 2 * R;
  const size_t smem =
      sizeof(float) * ((size_t)(PY + 2 * R) * (TW + D - 1) + 2 * PY * TW);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bm_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_tiles, (H + PY - 1) / PY, N);
  bm_kernel<BLOCK><<<grid, TW, smem, stream>>>(left, right, disp, best, cost,
                                               second, H, W, D, TC, reverse);
  return cudaGetLastError();
}

}  // namespace

// left, right: [N, H, W] f32 contiguous. disp, cost, second: [N, H, W] f32;
// best: [N, H, W] i32. block: odd, 1..15. Returns the CUDA error code of
// the launch (0 = launched); does not synchronise.
extern "C" int stereo_bm_launch(const void* left, const void* right,
                                void* disp, void* best, void* cost,
                                void* second, int N, int H, int W, int D,
                                int block, int reverse, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || D < 1 ||
      (H + PY - 1) / PY > 65535)
    return (int)cudaErrorInvalidValue;
#define BM_CASE(B)                                                          \
  case B:                                                                   \
    return (int)launch<B>((const float*)left, (const float*)right,          \
                          (float*)disp, (int*)best, (float*)cost,           \
                          (float*)second, N, H, W, D, reverse,              \
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
