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
// Design: a persistent, warp-specialised kernel. The grid is at most one
// block per SM; block g walks over the 16x16 output tiles g, g+G, g+2G...
// A block has four warpgroups in two roles that never reconverge. Every
// matrix product is a wgmma.mma_async with both operands read from shared
// memory by descriptor (no swizzle: a "core matrix" is 8 rows of 16 bytes,
// contiguous; rows of a group are 16 bytes apart, groups of 8 rows a
// stride-byte-offset apart, the two 8-element halves of a k16 step a
// leading-byte-offset apart).
//
//   * Warps 8-15, two producer warpgroups, make the conv1a activation of
//     the block's next tile: 18x18 pixels (16x16 plus conv1b's halo) x 64
//     channels, bf16, in the layout [cin/8][pixel][8], double-buffered.
//     conv1a runs on the tensor cores as the TPU kernel runs it on the
//     MXU: the 9 taps of a pixel, padded to K = 16, are a row of an
//     im2col matrix [k/8][pixel][8] that the producers build from a 20x20
//     shared input tile (9 loads, 2 16-byte stores a pixel); six
//     m64n64k16 products, three a warpgroup (M = 64 consecutive pixels, N
//     = the 64 channels, B = the conv1a weights packed once per block,
//     one left in flight while the previous one is stored) give the sums in
//     registers, where bias, ReLU and the zeroing outside the image
//     (conv1b must see SAME-padding zeros) happen before 4-byte stores
//     into the activation buffer. The next tile's input is fetched into
//     registers before the current tile is computed, and nothing uses
//     those registers until the tile after. A producer's steps are short
//     but each waits for the one before (loads, barrier, stores, fence,
//     barrier, wgmma, stores), so their time is latency; hence two
//     warpgroups, and a tile walk that keeps (image, row, column) by
//     carries instead of dividing per tile.
//   * Warps 0-7, two consumer warpgroups, run conv1b: warpgroup g takes
//     the block's tiles g, g+2, ... (always buffer g), so that one pools
//     and stores while the other's products run. The product is turned
//     round, D[cout][pixel] = W^T x act: A = the weights of one tap and 16
//     cins, [tap][cin/8][cout][8], staged ONCE per block by the consumers
//     while the producers are at their first tile (73,728 bytes; the host
//     packs them so, ops/superpoint_stem.py: pack_stem_weights);
//     B = 128 pixels x 16 cins of the activation, where the 16 groups of
//     8 pixels are 16 tile rows (stride-byte-offset = one tile row, 288
//     bytes), so N covers an 8 wide x 16 high patch and a tap shift
//     (dy, dx) is an offset of the descriptor's start address. m64n128k16
//     reads 6 KB of shared memory per 64 tensor-core clocks, where the
//     pixel-major m64n64k16 form reads 4 KB per 32: the shared-memory pipe
//     (128 bytes a clock) is what the tensor cores wait for. 36
//     instructions (9 taps x 4 cin chunks) a patch, two patches a tile.
//     Epilogue from registers: with N = 8 * row + x, a thread's registers
//     4j..4j+3 are (cout, cout + 8) x (x, x + 1) of patch row j, so the
//     2x2 max is in-thread; bias, ReLU, bf16; an 8x8 transpose over the
//     eight lanes that share a pooled column gathers 16 consecutive
//     channels of one pooled pixel, stored as two 16-byte words. No
//     staging buffer.
//
// Hand-over: mbarriers full[2] (256 producer arrivals, each after a
// fence.proxy.async: generic-proxy stores are read by the async proxy) and
// empty[2] (128 consumer arrivals after wgmma.wait_group 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsuperpoint_stem.so superpoint_stem.cu

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;            // pre-pool output tile (TILE x TILE)
constexpr int A1 = TILE + 2;        // conv1a tile side (1-pixel halo)
constexpr int NPIX = A1 * A1;       // 324 activation pixels
constexpr int MT1 = (NPIX + 63) / 64;  // conv1a M tiles of 64 pixels: 6
constexpr int IN = TILE + 4;        // input tile side (2-pixel halo)
constexpr int NIN = IN * IN;        // 400
constexpr int C = 64;               // channels

constexpr int CONSUMERS = 256;      // warps 0-7: two warpgroups
constexpr int PRODUCERS = 256;      // warps 8-15: two warpgroups
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int NPRE = (NIN + PRODUCERS - 1) / PRODUCERS;  // prefetch registers: 2

constexpr uint32_t ACT_SBO = A1 * 16;        // next tile row: 288 bytes
constexpr uint32_t ACT_LBO = NPIX * 16;      // next 8 channels: 5184 bytes
constexpr uint32_t ACT_BYTES = 8 * ACT_LBO;  // 41,472
constexpr uint32_t W_SBO = 8 * 16;           // next 8 couts: 128 bytes
constexpr uint32_t W_LBO = C * 16;           // next 8 cins (or taps): 1024 bytes
constexpr uint32_t W_TAP = 8 * W_LBO;        // 8192
constexpr uint32_t W_BYTES = 9 * W_TAP;      // 73,728
constexpr uint32_t COL_SBO = 8 * 16;         // im2col: next 8 pixels
constexpr uint32_t COL_LBO = MT1 * 64 * 16;  // im2col: taps 8..15: 6144 bytes

constexpr uint32_t OFF_W = 0;
constexpr uint32_t OFF_ACT = OFF_W + W_BYTES;
constexpr uint32_t OFF_COL = OFF_ACT + 2 * ACT_BYTES;
constexpr uint32_t OFF_W1 = OFF_COL + 2 * COL_LBO;
constexpr uint32_t OFF_IN = OFF_W1 + 2 * W_LBO;
constexpr uint32_t OFF_B2 = OFF_IN + NIN * sizeof(float);
constexpr uint32_t OFF_BAR = OFF_B2 + C * sizeof(float);
constexpr uint32_t SMEM_BYTES = OFF_BAR + 4 * sizeof(uint64_t);  // 172,896

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy shared-memory writes become visible to the async proxy
// (wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void producer_sync() {  // the producer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// commits the products started so far and waits for them
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// no-swizzle shared-memory matrix descriptor
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 operands from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] = A[64 x 16] * B[16 x 64], bf16 operands from shared memory
__device__ __forceinline__ void wgmma_m64n64k16_zero(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

template <int N>
__device__ __forceinline__ void keep_in_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Walks over the tiles first, first + step, first + 2 step, ... and keeps
// (image, tile row, tile column) by carries: the two divisions are paid once.
struct TileWalk {
  int tile, step, b, ty, tx, db, dty, dtx;

  __device__ TileWalk(int first, int step_, int tiles_y, int tiles_x)
      : tile(first), step(step_) {
    const int per_img = tiles_y * tiles_x;
    b = first / per_img;
    ty = (first - b * per_img) / tiles_x;
    tx = first - b * per_img - ty * tiles_x;
    db = step / per_img;
    dty = (step - db * per_img) / tiles_x;
    dtx = step - db * per_img - dty * tiles_x;
  }
  __device__ __forceinline__ void next(int tiles_y, int tiles_x) {
    tile += step;
    tx += dtx;
    ty += dty;
    b += db;
    if (tx >= tiles_x) { tx -= tiles_x; ++ty; }
    if (ty >= tiles_y) { ty -= tiles_y; ++b; }
  }
  __device__ __forceinline__ int y0() const { return ty * TILE; }
  __device__ __forceinline__ int x0() const { return tx * TILE; }
};

// the elements of the 20x20 input tile that producer thread `ptid` fetches,
// zero outside the image. Nothing here uses the loaded values, so the loads
// stay in flight while the caller computes the previous tile.
__device__ __forceinline__ void load_input(const float* __restrict__ img, int H, int W,
                                           int b, int y0, int x0, int ptid,
                                           float (&r)[NPRE]) {
  const float* im = img + size_t(b) * H * W;
#pragma unroll
  for (int k = 0; k < NPRE; ++k) {
    const int e = ptid + k * PRODUCERS;
    const int row = e / IN, col = e - row * IN;
    const int yy = y0 - 2 + row, xx = x0 - 2 + col;
    r[k] = 0.f;
    if (e < NIN && yy >= 0 && yy < H && xx >= 0 && xx < W) r[k] = im[size_t(yy) * W + xx];
  }
}

// conv1a epilogue of one M tile: bias, ReLU, zero outside the image, bf16,
// into the activation buffer. Rows r and r + 8 of the fragment are pixels;
// registers 4j..4j+3 are channels 8j + 2q, +1 of the two rows.
__device__ __forceinline__ void store_act(const float (&d)[32], unsigned char* act, int mt,
                                          int pw, int lane, const float (&bias)[16],
                                          int y0, int x0, int H, int W) {
  const int q = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = 64 * mt + 16 * pw + (lane >> 2) + 8 * hh;
    if (p >= NPIX) continue;
    const int i = p / A1, j = p - i * A1;
    const int yy = y0 - 1 + i, xx = x0 - 1 + j;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const float a = inside ? fmaxf(d[4 * c8 + 2 * hh] + bias[2 * c8], 0.f) : 0.f;
      const float b = inside ? fmaxf(d[4 * c8 + 2 * hh + 1] + bias[2 * c8 + 1], 0.f) : 0.f;
      *reinterpret_cast<uint32_t*>(act + c8 * ACT_LBO + p * 16 + q * 4) = pack_bf16x2(a, b);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const float* __restrict__ img,            // [B, H, W]
            const __nv_bfloat16* __restrict__ w1,     // [9, 64]
            const __nv_bfloat16* __restrict__ b1,     // [64]
            const __nv_bfloat16* __restrict__ w2,     // [9, 8, 64, 8]
            const __nv_bfloat16* __restrict__ b2,     // [64]
            __nv_bfloat16* __restrict__ out,          // [B, H/2, W/2, 64]
            int H, int W, int tiles_y, int tiles_x, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_in = reinterpret_cast<float*>(smem + OFF_IN);
  float* sb2 = reinterpret_cast<float*>(smem + OFF_B2);
  const uint32_t bar = smem_u32(smem + OFF_BAR);  // full[0], full[1], empty[0], empty[1]

  const int tid = threadIdx.x;
  const int G = gridDim.x;

  if (tid == 0) {
    mbar_init(bar + 0, PRODUCERS);
    mbar_init(bar + 8, PRODUCERS);
    mbar_init(bar + 16, CONSUMERS / 2);
    mbar_init(bar + 24, CONSUMERS / 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // conv1a weights as a B operand [k/8][cout][8], taps 9..15 zero
  for (int i = tid; i < 16 * C; i += THREADS) {
    const int k = i >> 6, c = i & 63;
    reinterpret_cast<__nv_bfloat16*>(smem + OFF_W1)[(k >> 3) * (C * 8) + c * 8 + (k & 7)] =
        k < 9 ? w1[k * C + c] : __float2bfloat16_rn(0.f);
  }
  if (tid < C) sb2[tid] = __bfloat162float(b2[tid]);
  fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ================= producers: conv1a into the activation ring
    const int ptid = tid - CONSUMERS;
    const int pg = ptid >> 7;           // producer warpgroup: M tiles pg, pg + 2, pg + 4
    const int pw = (ptid >> 5) & 3, lane = ptid & 31;
    float bias[16];  // channels 8 c8 + 2q, +1 for c8 = 0..7
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[2 * c8 + e] = __bfloat162float(b1[8 * c8 + 2 * (lane & 3) + e]);
    unsigned char* col = smem + OFF_COL;
    const uint64_t desc_col = make_desc(smem_u32(col), COL_LBO, COL_SBO);
    const uint64_t desc_w1 = make_desc(smem_u32(smem + OFF_W1), W_LBO, W_SBO);

    TileWalk t(blockIdx.x, G, tiles_y, tiles_x);
    float pre[NPRE];
    if (t.tile < n_tiles) load_input(img, H, W, t.b, t.y0(), t.x0(), ptid, pre);
    for (int it = 0; t.tile < n_tiles; ++it) {
      const int buf = it & 1;
#pragma unroll
      for (int k = 0; k < NPRE; ++k)
        if (ptid + k * PRODUCERS < NIN) s_in[ptid + k * PRODUCERS] = pre[k];
      producer_sync();
      const int y0 = t.y0(), x0 = t.x0();
      t.next(tiles_y, tiles_x);
      if (t.tile < n_tiles) load_input(img, H, W, t.b, t.y0(), t.x0(), ptid, pre);
      // im2col: the row of pixel p is its 9 taps, rounded to bf16, then zeros
      for (int p = ptid; p < NPIX; p += PRODUCERS) {
        const int i = p / A1, j = p - i * A1;
        const float* src = s_in + i * IN + j;
        float v[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) v[k] = src[(k / 3) * IN + k % 3];
        *reinterpret_cast<uint4*>(col + p * 16) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        *reinterpret_cast<uint4*>(col + COL_LBO + p * 16) =
            make_uint4(pack_bf16x2(v[8], 0.f), 0u, 0u, 0u);
      }
      fence_proxy_async();
      producer_sync();
      // the consumers have finished with this buffer's previous tile
      if (it >= 2) mbar_wait(bar + 16 + 8 * buf, ((it >> 1) - 1) & 1);
      unsigned char* act = smem + OFF_ACT + buf * ACT_BYTES;
      {
        float d0[32], d1[32];
        wgmma_fence();
        wgmma_m64n64k16_zero(d0, desc_col + ((pg * 64 * 16) >> 4), desc_w1);
        wgmma_m64n64k16_zero(d1, desc_col + (((pg + 2) * 64 * 16) >> 4), desc_w1);
        wgmma_commit_wait();
        keep_in_registers(d0);
        keep_in_registers(d1);
        store_act(d0, act, pg, pw, lane, bias, y0, x0, H, W);
        wgmma_fence();
        wgmma_m64n64k16_zero(d0, desc_col + (((pg + 4) * 64 * 16) >> 4), desc_w1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        store_act(d1, act, pg + 2, pw, lane, bias, y0, x0, H, W);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        keep_in_registers(d0);
        store_act(d0, act, pg + 4, pw, lane, bias, y0, x0, H, W);
      }
      fence_proxy_async();
      mbar_arrive(bar + 8 * buf);
    }
  } else {
    // ================= consumers: conv1b on wgmma, epilogue from registers
    // conv1b weights, already in the layout wgmma reads: a flat copy, once,
    // while the producers are at their first tile
    for (int i = tid; i < int(W_BYTES / 16); i += CONSUMERS)
      reinterpret_cast<uint4*>(smem + OFF_W)[i] = reinterpret_cast<const uint4*>(w2)[i];
    fence_proxy_async();
    asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
    const int wg = tid >> 7;            // takes every second tile of the block
    const int w = (tid >> 5) & 3;       // warp in the warpgroup: 16 couts
    const int lane = tid & 31;
    const int q = lane & 3;             // pooled column in the patch
    const int i8 = lane >> 2;           // cout in the warp's 8; pooled row stored
    const float bias0 = sb2[16 * w + i8], bias1 = sb2[16 * w + 8 + i8];
    const uint64_t desc_w = make_desc(smem_u32(smem + OFF_W), W_LBO, W_SBO);
    const int Ho = H >> 1, Wo = W >> 1;
    // the block's tile `it` lands in buffer it & 1, so this warpgroup always
    // reads buffer wg
    const uint32_t act_addr = smem_u32(smem + OFF_ACT + wg * ACT_BYTES);

    TileWalk t(blockIdx.x + wg * G, 2 * G, tiles_y, tiles_x);
    for (int u = 0; t.tile < n_tiles; ++u, t.next(tiles_y, tiles_x)) {
      mbar_wait(bar + 8 * wg, u & 1);
#pragma unroll 1
      for (int px = 0; px < TILE; px += 8) {  // left, right 8 x 16 patch
        const uint64_t desc_act = make_desc(act_addr + px * 16, ACT_LBO, ACT_SBO);
        float d[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            // descriptors differ in the start address only (16-byte units)
            const uint64_t da = desc_w + ((tap * W_TAP + kc * 2 * W_LBO) >> 4);
            const uint64_t db =
                desc_act + ((dy * ACT_SBO + dx * 16 + kc * 2 * ACT_LBO) >> 4);
            wgmma_m64n128k16(d, da, db, (tap | kc) != 0);
          }
        }
        wgmma_commit_wait();
        keep_in_registers(d);
        if (px) mbar_arrive(bar + 16 + 8 * wg);  // the activation buffer is free

        uint32_t u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float m0 =
              fmaxf(fmaxf(d[8 * k], d[8 * k + 1]), fmaxf(d[8 * k + 4], d[8 * k + 5]));
          const float m1 =
              fmaxf(fmaxf(d[8 * k + 2], d[8 * k + 3]), fmaxf(d[8 * k + 6], d[8 * k + 7]));
          u[k] = pack_bf16x2(fmaxf(m0 + bias0, 0.f), fmaxf(m1 + bias1, 0.f));
        }
        // 8x8 transpose over the lanes that share q: lane i8 ends with pooled
        // row i8, word c = couts (16w + c, 16w + 8 + c)
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int m = 1 << r;
          const bool up = i8 & m;
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            if (a & m) continue;
            const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? u[a] : u[a | m], 4 * m);
            if (up) u[a] = got; else u[a | m] = got;
          }
        }
        const int oy = (t.y0() >> 1) + i8;
        const int ox = ((t.x0() + px) >> 1) + q;
        if (oy < Ho && ox < Wo) {
          uint4 lo, hi;  // couts 16w .. 16w+7 and 16w+8 .. 16w+15
          lo.x = __byte_perm(u[0], u[1], 0x5410);
          lo.y = __byte_perm(u[2], u[3], 0x5410);
          lo.z = __byte_perm(u[4], u[5], 0x5410);
          lo.w = __byte_perm(u[6], u[7], 0x5410);
          hi.x = __byte_perm(u[0], u[1], 0x7632);
          hi.y = __byte_perm(u[2], u[3], 0x7632);
          hi.z = __byte_perm(u[4], u[5], 0x7632);
          hi.w = __byte_perm(u[6], u[7], 0x7632);
          uint4* dst = reinterpret_cast<uint4*>(
              out + ((size_t(t.b) * Ho + oy) * Wo + ox) * C + 16 * w);
          dst[0] = lo;
          dst[1] = hi;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). ``grid`` is the number of
// persistent blocks (at most one per SM and one per tile; the caller
// knows the card's SM count). Launches on ``stream`` and returns the CUDA error code of
// the launch as an int; 0 means the launch was taken.
extern "C" int superpoint_stem_launch(const float* img, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, void* out, int B,
                                      int H, int W, int grid, void* stream) {
  const int tiles_y = (H + TILE - 1) / TILE, tiles_x = (W + TILE - 1) / TILE;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || grid < 1 ||
      n_tiles > 0x3fffffffLL || grid > n_tiles)
    return int(cudaErrorInvalidValue);
  // the attribute is per device; set it once for each
  static std::atomic<bool> configured[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(
        stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      img, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(out), H, W, tiles_y, tiles_x, int(n_tiles));
  return int(cudaGetLastError());
}
