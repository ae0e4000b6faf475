// Fused SuperPoint stem for Hopper (sm_90a):
//   conv1a 3x3 1->64 + bias + ReLU, conv1b 3x3 64->64 + bias + ReLU,
//   2x2 max-pool; SAME zero padding.
//
// Replaces the TPU kernel d2slam_tpu/ops/superpoint_stem_pallas.py
// (_stem_kernel). Same rounding: bf16 image, weights and biases; conv
// sums in f32; bias added in f32; the conv1a activation is rounded once
// to bf16; the pooled output is bf16.
//
// Bound: 2*B*H*W*64*(9+576) FLOPs, 576 of every 585 MACs in conv1b, so
// the stem is tensor-core bound (46.0 GFLOP at B=2, 480x640: ~46.5 us at
// 989 TF/s bf16 dense, against ~6.6 us for its 22 MB of traffic).
//
// Design: one thread block per (image, 16x16 output tile), 8 warps.
//   1. The 20x20 input tile (2-pixel halo, zero outside the image) is
//      loaded into shared memory as bf16-rounded floats.
//   2. conv1a is computed on the 18x18 tile + 1-pixel halo with FMA
//      loops, forced to zero outside the image (conv1b must see SAME
//      padding zeros), rounded to bf16 and kept in shared memory as
//      [pixel][channel] rows.
//   3. conv1b is an implicit GEMM on the tensor cores: each warp owns
//      two output rows (M = 16 pixels each) x 64 output channels
//      (4 N-fragments) and accumulates 9 taps x 4 K-chunks of
//      16x16x16 bf16 WMMA products in f32. A-fragments are read
//      straight out of the conv1a rows (a tap shift is a pointer
//      offset); the weights sit in shared memory as [tap][cin][cout].
//   4. Epilogue per warp: the two rows' accumulators go through a
//      small f32 staging buffer; 2x2 max, bias, ReLU (max commutes with
//      the monotone bias+ReLU) and the bf16 store happen per lane. Only
//      the pooled tile reaches device memory.
// Rows of the conv1a and weight buffers are padded from 64 to 80
// elements (160 bytes) to spread ldmatrix rows across banks while
// keeping the 32-byte alignment WMMA loads need.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsuperpoint_stem.so superpoint_stem.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 16;            // pre-pool output tile (TILE x TILE)
constexpr int A1 = TILE + 2;        // conv1a tile side (1-pixel halo)
constexpr int IN = TILE + 4;        // input tile side (2-pixel halo)
constexpr int C = 64;               // channels
constexpr int LD = 80;              // padded row length (elements)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

constexpr size_t SMEM_W2 = size_t(9) * C * LD * sizeof(__nv_bfloat16);      // 92,160
constexpr size_t SMEM_ACT = size_t(A1) * A1 * LD * sizeof(__nv_bfloat16);   // 51,840
constexpr size_t SMEM_IN = size_t(IN) * IN * sizeof(float);                 //  1,600
constexpr size_t SMEM_STAGE = size_t(WARPS) * 2 * 16 * 16 * sizeof(float);  // 16,384
constexpr size_t SMEM_BYTES = SMEM_W2 + SMEM_ACT + SMEM_IN + SMEM_STAGE;

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const float* __restrict__ img,            // [B, H, W]
            const __nv_bfloat16* __restrict__ w1,     // [9, 64]
            const __nv_bfloat16* __restrict__ b1,     // [64]
            const __nv_bfloat16* __restrict__ w2,     // [9, 64(cin), 64(cout)]
            const __nv_bfloat16* __restrict__ b2,     // [64]
            __nv_bfloat16* __restrict__ out,          // [B, H/2, W/2, 64]
            int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sw2 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sact = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W2);
  float* stile = reinterpret_cast<float*>(smem + SMEM_W2 + SMEM_ACT);
  float* sstage = reinterpret_cast<float*>(smem + SMEM_W2 + SMEM_ACT + SMEM_IN);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const float* im = img + size_t(b) * H * W;

  // ---- stage conv1b weights: 9*64 rows of 128 bytes, 16 bytes a thread
  for (int i = tid; i < 9 * C * 8; i += THREADS) {
    const int row = i >> 3, part = i & 7;
    const uint4 v = reinterpret_cast<const uint4*>(w2 + size_t(row) * C)[part];
    reinterpret_cast<uint4*>(sw2 + size_t(row) * LD)[part] = v;
  }
  // ---- input tile with a 2-pixel halo, bf16-rounded, zero outside
  for (int i = tid; i < IN * IN; i += THREADS) {
    const int yy = y0 - 2 + i / IN, xx = x0 - 2 + i % IN;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = __bfloat162float(__float2bfloat16_rn(im[size_t(yy) * W + xx]));
    stile[i] = v;
  }
  __syncthreads();

  // ---- conv1a on the 18x18 tile: thread = (channel, pixel group)
  {
    const int c = tid & (C - 1);
    const int grp = tid >> 6;  // 0..3
    float wc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wc[k] = __bfloat162float(w1[k * C + c]);
    const float bc = __bfloat162float(b1[c]);
    for (int p = grp; p < A1 * A1; p += THREADS / C) {
      const int i = p / A1, j = p % A1;
      const int yy = y0 - 1 + i, xx = x0 - 1 + j;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = fmaf(stile[(i + dy) * IN + (j + dx)], wc[dy * 3 + dx], acc);
      float v = fmaxf(acc + bc, 0.f);
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) v = 0.f;
      sact[p * LD + c] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // ---- conv1b: implicit GEMM with WMMA bf16 16x16x16, f32 accumulate
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 2;  // this warp's two tile rows
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::load_matrix_sync(bf[n], sw2 + size_t(tap * C + kc * 16) * LD + n * 16, LD);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, sact + size_t((r0 + m + dy) * A1 + dx) * LD + kc * 16, LD);
#pragma unroll
        for (int n = 0; n < 4; ++n) wmma::mma_sync(acc[m][n], af, bf[n], acc[m][n]);
      }
    }
  }

  // ---- epilogue: 2x2 max, bias, ReLU, bf16 store of the pooled row
  float* st = sstage + warp * 2 * 256;
  const int oy = (y0 + r0) >> 1;
  const int Ho = H >> 1, Wo = W >> 1;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(st, acc[0][n], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(st + 256, acc[1][n], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = lane + 32 * q;       // 8 pooled px x 16 channels
      const int px = idx >> 4, ch = idx & 15;
      const int a = (2 * px) * 16 + ch, bb = (2 * px + 1) * 16 + ch;
      const float v = fmaxf(fmaxf(st[a], st[bb]), fmaxf(st[256 + a], st[256 + bb]));
      const int ox = (x0 >> 1) + px;
      if (oy < Ho && ox < Wo) {
        const float o = fmaxf(v + __bfloat162float(b2[n * 16 + ch]), 0.f);
        out[((size_t(b) * Ho + oy) * Wo + ox) * C + n * 16 + ch] = __float2bfloat16_rn(o);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() as an int; 0 means the launch was taken.
extern "C" int superpoint_stem_launch(const float* img, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, void* out, int B,
                                      int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      img, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(out), H, W);
  return int(cudaGetLastError());
}
