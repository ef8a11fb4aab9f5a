// Kernel A: windowed multi-head attention with relative-position bias and
// the shifted-window mask, forward only.
//
// Replaces the TPU kernel multimodal_organ_segmentation_tpu/ops/pallas/
// window_attention.py::_kernel (launched by _window_mha_fwd_impl, public
// window_mha). Same function: for every window w of every batch element and
// every head h,
//     out = softmax(q.k^T * D^-1/2 + bias[h] + mask[w]) . v
// with f32 sums and the output in q's dtype.
//
// What bounds it on an H100: at the SwinUNETR shapes (N = 216 tokens, head
// dim D = 16) each (window, head) does 4*N*N*D flops and N*N exponentials
// on 2*N*D inputs. Over one serving chunk of 15 tiles that is 2.86e9
// exponentials: 0.68 ms at the special-function units' 16 a clock an SM,
// against 0.185 ms for the products at the bf16 tensor-core rate and
// 0.54 ms for the bytes. The exponentials bound it.
//
// Three routes, chosen by the wrapper (ops/window_attention.py::plan):
//
// wgmma (bf16, D a multiple of 16 up to 64, 16-byte aligned rows, N up to
//  256 where a ring stage fits beside the staged bias): Hopper's warpgroup
//  products fed by TMA, with a whole row of scores in the accumulators:
//  * one block of 384 threads per (head h, window position w) walks a
//    group of the batch's tiles b: two consumer warpgroups and a producer
//    warpgroup that gives them its registers (setmaxnreg 40 / 232). The
//    walk's length is the plan's (wgmma_walk): one block fills an SM, so
//    the grid runs in waves of 132, and the walk trades the waves against
//    each block's staging of the bias;
//  * the consumers stage (bias[h] + mask[w]) * log2(e) once a block in
//    fp16, as the mma route does, with many float4 reads in flight a
//    thread (the staging's time is the reads' latency), every row of the
//    window: 224 x 216 halves, 97 KB at N = 216;
//  * one producer thread streams each tile's Q, K and V rows of (b, w, h)
//    by TMA into a ring of up to 3 stages under full / empty mbarriers, as
//    [D/8][rows][8] (one box per 8-dim group; rows past N arrive as zeros):
//    the no-swizzle core-matrix layout, K-major for Q and K, MN-major for V;
//  * a window's rows are 64-row tiles (4 at N = 216) that the two
//    warpgroups take in turn. S for a tile's whole row is one m64n64k16 per
//    64 keys and 16 dims (4 at N = 216, D = 16): all the keys in the
//    accumulators, so one max, one pass of ex2 and one sum, and no
//    rescale. The bias is added from shared memory; a warp whose 16 rows all
//    lie past N skips its exponentials (rows 224-255 at N = 216); P goes
//    in bf16 from the accumulators into the A operand (registers) of
//    O = P.V, m64nDk16 over 14 k16 steps (224 keys) at N = 216.
//
// mma (bf16, D a multiple of 16 up to 64, 16-byte aligned rows; the
//  windows past the wgmma route: N = 343 and 512): the
//  products go to mma.sync m16n8k16 tensor-core tiles, so what is left is
//  the exponentials, one ex2 a score (log2(e) folded into the scale and the
//  staged bias), and the bias and mask reads that would otherwise feed them:
//  * one block per (head h, window position w, block of query rows) walks
//    the batch's tiles b (window bw = b*nW + w). Walks longer than 16 tiles
//    (unshifted blocks, where nW = 1 and every window is a "tile"), and
//    walks on a grid too small to give each SM two blocks, are cut into
//    groups along gridDim.y;
//  * bias[h] and mask[w] are the same for every tile, so the block stages
//    its rows of (bias[h] + mask[w]) * log2(e) once in shared memory and
//    reuses them for every tile (15 in serving, 2 in training) instead of
//    reading 8 bytes a score from L2 for every (window, head, tile). They
//    are staged in fp16, clamped to +-65504 (-inf in the padding columns
//    past N): half the bytes of f32, so that a block of 7 warps covers half
//    a 216-token window and two such blocks fit an SM (14 warps, where f32
//    staging fits 8). fp16 keeps 11 bits: an added error of at most 2^-12
//    relative in the exponent, below the bf16 rounding of P; a shift-mask
//    entry (-1e9) stays a probability of 0. Blocks run window-slowest so
//    the heads of one window read mask[w] from DRAM once;
//  * Q rows and all K/V rows of tile b stream in by 16-byte cp.async,
//    double-buffered: tile b+1 loads while tile b computes. Rows are padded
//    to D+8 elements (conflict-free ldmatrix); keys past N are zero rows;
//  * each warp owns 16 query rows: one A fragment a 16-dim k-step, QK^T
//    into m16n8 accumulators, the staged bias added in registers, then the
//    online softmax and P.V of mma.cuh (P from the score registers into A
//    fragments in bf16, never through shared memory; O is 16 x D f32,
//    normalised once), over chunks of 128 keys (two for a 216-token window),
//    which keeps D = 16 within the 128 registers a thread that two 7-warp
//    blocks an SM allow. Whole 256-key rows in registers (one max, one pass
//    of ex2) took 191 registers and one block an SM, and were slower;
//  * the query-row block (16 x warps, up to 8 warps) is the fewest row
//    blocks that cover N with the plan fitting shared memory: 2 x 7 warps
//    at N = 216, 3 x 8 at N = 343, 5 x 7 at N = 512.
//
// f32 (float32, and bf16 at the head dims or alignments the mma route does
// not take): the first version, on the f32 pipes, kept for exact checks:
//  * one block of 8 warps per (window, head); K and V of that pair are staged
//    once in shared memory as f32, rows padded to D+4 floats so that one
//    lane per key reads them as float4 with no bank conflicts;
//  * one warp per query row: each lane owns keys lane, lane+32, ... (at most
//    16, so N <= 512), keeps its scores in registers, and the softmax max and
//    sum are warp shuffles. Bias and mask rows are read coalesced, straight
//    from global memory, exactly once per (window, head);
//  * the block index runs head fastest, then batch element, then window, so
//    the blocks that read mask[w] run close together and their repeated reads
//    can hit in L2.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

#include <cuda_fp16.h>

namespace organseg {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kHalfMax = 65504.f;

// ---- wgmma route -------------------------------------------------------

constexpr int kWgThreads = 384;  // two consumer warpgroups and the producer warpgroup
constexpr int kWgConsumers = 256;
constexpr int kWgMaxStages = 3;
constexpr int kWgBars = 8 * 2 * kWgMaxStages;

// The score columns of a window of n tokens, in n8 tiles: the fewest of 8,
// 16, 27 or 32 that cover n (each is a build of the kernel).
__host__ __device__ constexpr int wgmma_key_tiles(int n) { return n <= 64 ? 8 : n <= 128 ? 16 : n <= 216 ? 27 : 32; }

// The wgmma route's shared-memory pieces for n tokens, head dim d: the
// staged bias rows [kpad][bias_stride] fp16 (bias_stride = 8 mod 16
// elements: conflict-free half2 reads), rounded up to 128 bytes, and one
// ring stage, Q [d/8][64 * ceil(n/64)][8], K and V [d/8][kpad][8], bf16.
struct WgmmaLayout {
  int nt8, kpad, row_tiles, qpad, bias_stride, bias_bytes, stage_bytes;
};

__host__ __device__ constexpr WgmmaLayout wgmma_layout(int n, int d) {
  const int nt8 = wgmma_key_tiles(n);
  const int kpad = 16 * ((nt8 + 1) / 2);
  const int row_tiles = (n + 63) / 64;
  const int bias_stride = 8 * nt8 + (nt8 % 2 ? 0 : 8);
  return {nt8, kpad, row_tiles, 64 * row_tiles, bias_stride,
          (2 * kpad * bias_stride + 127) / 128 * 128, (64 * row_tiles + 2 * kpad) * d * 2};
}

constexpr int wgmma_smem_bytes(int n, int d, int stages) {
  return wgmma_layout(n, d).bias_bytes + stages * wgmma_layout(n, d).stage_bytes + kWgBars + 128;
}

__device__ __forceinline__ __half stage_value(float x, int i, int j, int n) {
  float y = j < n ? (i < n ? x * kLog2e : 0.f) : -INFINITY;
  if (y == y && j < n) y = fminf(fmaxf(y, -kHalfMax), kHalfMax);  // NaN stays NaN
  return __float2half_rn(y);
}

// The wgmma route's staged bias, [KPAD][BS] fp16 in shared memory: element
// (i, j) is (bias_h + mask_w)[i, j] * log2(e) for i, j < n, 0 in the rows
// past n and -inf in the columns past n (up to 8 NT8). The staging's time
// is the reads' latency, so each thread keeps many in flight: four float4
// loads of each table at once where rows are whole float4s (n % 4 == 0 and
// 16-byte aligned tables), eight scalar ones otherwise.
template <int NT8, int KPAD, int BS>
__device__ __forceinline__ void stage_bias(__half* bm, const float* __restrict__ bias_h,
                                           const float* __restrict__ mask_w, int n, int tid,
                                           int threads) {
  constexpr int kCols = 8 * NT8;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(bias_h) % 16 == 0) &&
                   (mask_w == nullptr || reinterpret_cast<uintptr_t>(mask_w) % 16 == 0);
  if (vec) {
    constexpr int kU = 4;
    const int quads = n * n / 4;
    const float4* b4 = reinterpret_cast<const float4*>(bias_h);
    const float4* m4 = reinterpret_cast<const float4*>(mask_w);
    for (int e0 = tid; e0 < quads; e0 += kU * threads) {
      float4 x[kU], y[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = min(e0 + u * threads, quads - 1);
        x[u] = __ldg(b4 + e);
        y[u] = mask_w ? __ldg(m4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * threads;
        if (e >= quads) break;
        const int i = 4 * e / n, j = 4 * e - i * n;
        __half2* dst = reinterpret_cast<__half2*>(bm + i * BS + j);
        dst[0] = __halves2half2(stage_value(x[u].x + y[u].x, i, j, n),
                                stage_value(x[u].y + y[u].y, i, j + 1, n));
        dst[1] = __halves2half2(stage_value(x[u].z + y[u].z, i, j + 2, n),
                                stage_value(x[u].w + y[u].w, i, j + 3, n));
      }
    }
    // the padding: rows past n (0), then columns past n (-inf)
    for (int e = tid; e < (KPAD - n) * n; e += threads) {
      const int i = n + e / n;
      bm[i * BS + e % n] = __float2half_rn(0.f);
    }
    for (int e = tid; e < KPAD * (kCols - n); e += threads) {
      const int i = e / (kCols - n);
      bm[i * BS + n + e % (kCols - n)] = __float2half_rn(-INFINITY);
    }
    return;
  }
  constexpr int kU = 8;
  for (int e0 = tid; e0 < KPAD * kCols; e0 += kU * threads) {
    float x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * threads;
      const int i = e / kCols, j = e - (e / kCols) * kCols;
      const int off = (i < n && j < n) ? i * n + j : 0;
      x[u] = __ldg(bias_h + off);
      if (mask_w) x[u] += __ldg(mask_w + off);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * threads;
      const int i = e / kCols, j = e - (e / kCols) * kCols;
      if (i >= KPAD) break;
      bm[i * BS + j] = stage_value(x[u], i, j, n);
    }
  }
}

template <int D, int NT8>
__global__ void __launch_bounds__(kWgThreads, 1)
window_mha_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                        const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int n,
                        int heads, int num_windows, int batch, int tiles_per_block, int stages,
                        float scale_log2) {
  constexpr int G = D / 8;                // 8-dim groups: the TMA boxes of a window
  constexpr int NC = (NT8 + 7) / 8;       // m64n64 score chunks
  constexpr int KS = (NT8 + 1) / 2;       // k16 steps of P.V
  constexpr WgmmaLayout L = wgmma_layout(8 * NT8, D);
  constexpr int KPAD = L.kpad;
  constexpr int BS = L.bias_stride;
  const int row_tiles = (n + 63) / 64;
  const int qpad = 64 * row_tiles;
  const int stage_bytes = (qpad + 2 * KPAD) * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  __half* bm = reinterpret_cast<__half*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t ring = base + L.bias_bytes;
  const uint32_t bars = ring + stages * stage_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kWgMaxStages + s); };

  const int h = blockIdx.x % heads;
  const int w = blockIdx.x / heads;
  const int b_first = blockIdx.y * tiles_per_block;
  const int b_last = min(batch, b_first + tiles_per_block);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // producer warpgroup: one thread streams each tile's Q, K and V of
    // window (b, w), head h
    setmaxnreg_dec<40>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      for (int b = b_first, it = 0; b < b_last; ++b, ++it) {
        const int s = it % stages;
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        const uint32_t qs = ring + s * stage_bytes;
        const uint32_t ks = qs + qpad * D * 2;
        const uint32_t vs = ks + KPAD * D * 2;
        const int bw = b * num_windows + w;
        mbar_arrive_expect_tx(full(s), stage_bytes);
        for (int g = 0; g < G; ++g) {
          tma_load_4d(qs + g * qpad * 16, &qmap, full(s), 8 * g, h, 0, bw);
          tma_load_4d(ks + g * KPAD * 16, &kmap, full(s), 8 * g, h, 0, bw);
          tma_load_4d(vs + g * KPAD * 16, &vmap, full(s), 8 * g, h, 0, bw);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // (bias[h] + mask[w]) * log2(e) in fp16, every row once for all the
  // block's tiles; -inf in the columns past n, 0 in the rows past n
  const float* bias_h = bias + static_cast<long long>(h) * n * n;
  const float* mask_w = mask ? mask + static_cast<long long>(w) * n * n : nullptr;
  stage_bias<NT8, KPAD, BS>(bm, bias_h, mask_w, n, threadIdx.x, kWgConsumers);
  named_barrier_sync(1, kWgConsumers);

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  for (int b = b_first, it = 0; b < b_last; ++b, ++it) {
    const int s = it % stages;
    mbar_wait(full(s), (it / stages) & 1);
    const uint32_t qs = ring + s * stage_bytes;
    const uint32_t ks = qs + qpad * D * 2;
    const uint32_t vs = ks + KPAD * D * 2;
    const long long bw = static_cast<long long>(b) * num_windows + w;
    // the tile's 64-row tiles go to the two warpgroups in turn, the turn
    // moving by one each tile when row_tiles is even
    const int first = it * row_tiles + (row_tiles % 2 ? 0 : it);
    for (int rt = (first + wg) & 1; rt < row_tiles; rt += 2) {
      // S = Q.K^T for the whole row: NC chunks of m64n64, D/16 k-steps each
      float sc[NC][32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64>(sc[c], wgmma_desc(qs + (2 * kk * qpad + 64 * rt) * 16, qpad * 16, 128),
                       wgmma_desc(ks + (2 * kk * KPAD + 64 * c) * 16, KPAD * 16, 128),
                       kk > 0 ? 1u : 0u);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) wgmma_fence_operands(sc[c]);

      // one max, one pass of ex2 and one sum over all the keys; a warp whose
      // 16 rows all lie past n skips them (its P is 0)
      const int wrow = 64 * rt + 16 * (warp & 3);
      uint32_t pa[KS][4];
      float l[2] = {0.f, 0.f};
      if (wrow < n) {
        const __half* brow = bm + (wrow + g) * BS + t2;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          float* t = &sc[nt / 8][4 * (nt % 8)];
          const float2 b0 = __half22float2(*reinterpret_cast<const __half2*>(brow + 8 * nt));
          const float2 b1 = __half22float2(*reinterpret_cast<const __half2*>(brow + 8 * BS + 8 * nt));
          t[0] = fmaf(t[0], scale_log2, b0.x);
          t[1] = fmaf(t[1], scale_log2, b0.y);
          t[2] = fmaf(t[2], scale_log2, b1.x);
          t[3] = fmaf(t[3], scale_log2, b1.y);
          mx[0] = fmaxf(mx[0], fmaxf(t[0], t[1]));
          mx[1] = fmaxf(mx[1], fmaxf(t[2], t[3]));
        }
        float base_r[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          base_r[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
        }
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          float* t = &sc[nt / 8][4 * (nt % 8)];
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = fast_exp2(t[e] - base_r[e >> 1]);
          l[0] += t[0] + t[1];
          l[1] += t[2] + t[3];
        }
#pragma unroll
        for (int p = 0; p < KS; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int nt = 2 * p + hh;
            const float* t = &sc[nt / 8][4 * (nt % 8)];
            pa[p][2 * hh] = nt < NT8 ? pack_bf16(t[0], t[1]) : 0u;
            pa[p][2 * hh + 1] = nt < NT8 ? pack_bf16(t[2], t[3]) : 0u;
          }
      } else {
#pragma unroll
        for (int p = 0; p < KS; ++p) pa[p][0] = pa[p][1] = pa[p][2] = pa[p][3] = 0u;
      }

      // O = P.V: KS k-steps of m64nDk16, V MN-major [d/8][kpad][8]; V's
      // rows past n are zeros
      float o[D / 2];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < KS; ++p)
        wgmma_rs<D>(o, pa[p], wgmma_desc(vs + p * 16 * 16, 128, KPAD * 16), p > 0 ? 1u : 0u);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(o);
#pragma unroll
      for (int p = 0; p < KS; ++p) wgmma_fence_operands(pa[p]);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = quad_sum(l[r]);
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
        const int row = wrow + g + 8 * r;
        if (row >= n) continue;
        __nv_bfloat16* dst = out + ((bw * n + row) * heads + h) * D + t2;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<uint32_t*>(dst + 8 * nt) =
              pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
}

template <int D, int NT8>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, long long stride_w,
                         long long stride_n, const float* bias, const float* mask, void* out,
                         int bw, int n, int heads, int num_windows, float scale_log2,
                         int tiles_per_block, int stages, dim3 grid, int threads, int smem,
                         cudaStream_t stream) {
  const int batch = bw / num_windows;
  const WgmmaLayout lay = wgmma_layout(n, D);
  if (tiles_per_block < 1 || stages < 1 || stages > kWgMaxStages || threads != kWgThreads ||
      grid.x != static_cast<unsigned>(heads * num_windows) ||
      grid.y != static_cast<unsigned>((batch + tiles_per_block - 1) / tiles_per_block) ||
      smem != wgmma_smem_bytes(n, D, stages))
    return cudaErrorInvalidConfiguration;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (encode_rows_map(encode, &qmap, q, D, heads, n, bw, stride_n, stride_w, lay.qpad) !=
          CUDA_SUCCESS ||
      encode_rows_map(encode, &kmap, k, D, heads, n, bw, stride_n, stride_w, lay.kpad) !=
          CUDA_SUCCESS ||
      encode_rows_map(encode, &vmap, v, D, heads, n, bw, stride_n, stride_w, lay.kpad) !=
          CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = window_mha_wgmma_kernel<D, NT8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(qmap, kmap, vmap, bias, mask,
                                             static_cast<__nv_bfloat16*>(out), n, heads,
                                             num_windows, batch, tiles_per_block, stages,
                                             scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_key_tiles(const void* q, const void* k, const void* v, long long stride_w,
                               long long stride_n, const float* bias, const float* mask,
                               void* out, int bw, int n, int heads, int num_windows,
                               float scale_log2, int tiles_per_block, int stages, dim3 grid,
                               int threads, int smem, cudaStream_t stream) {
#define ORGANSEG_CASE(NT)                                                                      \
  case NT:                                                                                     \
    return launch_wgmma<D, NT>(q, k, v, stride_w, stride_n, bias, mask, out, bw, n, heads,     \
                               num_windows, scale_log2, tiles_per_block, stages, grid, threads, \
                               smem, stream);
  switch (wgmma_key_tiles(n)) {
    ORGANSEG_CASE(8)
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(27)
    ORGANSEG_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}

// ---- mma route ---------------------------------------------------------

// Shared memory of the mma route: the staged bias rows [rows][bm_stride]
// fp16, then two buffers of [rows + 2 * kpad][D + 8] bf16 (Q rows, K, V).
constexpr long long mma_smem_bytes(int rows, int kpad, int bm_stride, int d) {
  return 2LL * rows * bm_stride + 2LL * 2 * (rows + 2 * kpad) * (d + 8);
}

template <int D>
__global__ void __launch_bounds__(256, D == 16 ? 2 : 1)
window_mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, long long stride_w,
                      long long stride_n, const float* __restrict__ bias,
                      const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int n,
                      int heads, int num_windows, int batch, int row_blocks,
                      int tiles_per_block, int kpad, int bm_stride, float scale_log2) {
  constexpr int S = D + 8;   // shared row stride, elements
  constexpr int CH = D / 8;  // 16-byte chunks a row
  constexpr int KT = 16;     // n8 key tiles a chunk of the online softmax: 128 keys
  const int warps = blockDim.x >> 5;
  const int rows = 16 * warps;  // query rows of this block
  extern __shared__ uint4 smem16[];
  __half* bm = reinterpret_cast<__half*>(smem16);                           // [rows][bm_stride]
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(bm + rows * bm_stride);
  const int buf_elems = (rows + 2 * kpad) * S;                              // Q rows, K, V

  int idx = blockIdx.x;
  const int rb = idx % row_blocks;
  idx /= row_blocks;
  const int h = idx % heads;
  const int w = idx / heads;
  const int r0 = rb * rows;
  const int b_first = blockIdx.y * tiles_per_block;
  const int b_last = min(batch, b_first + tiles_per_block);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Q rows r0.. and every K, V row of window (b, w), head h; zeros past N
  auto stage = [&](int b, __nv_bfloat16* dst) {
    const long long base = (static_cast<long long>(b) * num_windows + w) * stride_w + h * D;
    const int units = (rows + 2 * kpad) * CH;
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int r = e / CH;
      const int c = e - r * CH;
      const __nv_bfloat16* src;
      int tok;
      if (r < rows) {
        src = q;
        tok = r0 + r;
      } else if (r < rows + kpad) {
        src = k;
        tok = r - rows;
      } else {
        src = v;
        tok = r - rows - kpad;
      }
      const bool in = tok < n;
      cp_async_16(dst + r * S + c * 8, src + base + (in ? tok : 0) * stride_n + c * 8, in);
    }
  };
  stage(b_first, tiles);
  cp_async_commit();

  // this block's rows of (bias[h] + mask[w]) * log2(e) in fp16; -inf past N
  const float* bias_h = bias + static_cast<long long>(h) * n * n;
  const float* mask_w = mask ? mask + static_cast<long long>(w) * n * n : nullptr;
  for (int r = warp; r < rows; r += warps) {
    const int i = r0 + r;
    for (int j = lane; j < kpad; j += 32) {
      float x = -INFINITY;
      if (j < n) {
        x = 0.f;
        if (i < n) {
          x = bias_h[i * n + j];
          if (mask_w) x += mask_w[i * n + j];
          if (x == x) x = fminf(fmaxf(x * kLog2e, -kHalfMax), kHalfMax);  // NaN stays NaN
        }
      }
      bm[r * bm_stride + j] = __float2half_rn(x);
    }
  }

  const __half* bm_g = bm + (warp * 16 + (lane >> 2)) * bm_stride + 2 * (lane & 3);
  for (int b = b_first; b < b_last; ++b) {
    const int buf = (b - b_first) & 1;
    if (b + 1 < b_last) stage(b + 1, tiles + (buf ^ 1) * buf_elems);
    cp_async_commit();
    cp_async_wait<1>();  // tile b has landed
    __syncthreads();     // ... for every thread, and (first pass) bm is written

    const __nv_bfloat16* qs = tiles + buf * buf_elems;
    const __nv_bfloat16* ks = qs + rows * S;
    const __nv_bfloat16* vs = ks + kpad * S;
    uint32_t qf[D / 16][4];
    load_q_fragments(qf, qs + warp * 16 * S, S, lane);
    float o[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int c0 = 0; c0 < kpad; c0 += 8 * KT) {
      const int steps = min(KT / 2, (kpad - c0) / 16);
      float s[KT][4];
      qk_chunk(s, qf, ks + c0 * S, S, steps, lane);
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        if (nt / 2 < steps) {
          const float2 b0 =
              __half22float2(*reinterpret_cast<const __half2*>(bm_g + c0 + 8 * nt));
          const float2 b1 = __half22float2(
              *reinterpret_cast<const __half2*>(bm_g + 8 * bm_stride + c0 + 8 * nt));
          s[nt][0] = fmaf(s[nt][0], scale_log2, b0.x);
          s[nt][1] = fmaf(s[nt][1], scale_log2, b0.y);
          s[nt][2] = fmaf(s[nt][2], scale_log2, b1.x);
          s[nt][3] = fmaf(s[nt][3], scale_log2, b1.y);
        }
      }
      softmax_pv_chunk(s, steps, m, l, o, vs + c0 * S, S, lane);
    }

    const long long bw = static_cast<long long>(b) * num_windows + w;
    const int row0 = r0 + warp * 16;
    store_rows(o, l, out + ((bw * n + row0) * heads + h) * D,
               static_cast<long long>(heads) * D, n - row0, lane);
    __syncthreads();  // every warp is done with buffer `buf` before it refills
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, long long stride_w,
                       long long stride_n, const float* bias, const float* mask, void* out,
                       int bw, int n, int heads, int num_windows, float scale_log2, int warps,
                       int tiles_per_block, dim3 grid, int smem, cudaStream_t stream) {
  const int batch = bw / num_windows;
  const int rows = 16 * warps;
  const int row_blocks = (n + rows - 1) / rows;
  const int kpad = (n + 15) / 16 * 16;
  const int bm_stride = kpad + 8;  // fp16; = 8 mod 16: conflict-free half2 reads
  if (warps < 1 || warps > 8 || tiles_per_block < 1 ||
      grid.x != static_cast<unsigned>(row_blocks * heads * num_windows) ||
      grid.y != static_cast<unsigned>((batch + tiles_per_block - 1) / tiles_per_block) ||
      smem != mma_smem_bytes(rows, kpad, bm_stride, D))
    return cudaErrorInvalidConfiguration;
  auto kernel = window_mha_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), stride_w, stride_n, bias, mask,
      static_cast<__nv_bfloat16*>(out), n, heads, num_windows, batch, row_blocks,
      tiles_per_block, kpad, bm_stride, scale_log2);
  return cudaGetLastError();
}

// ---- f32 route ---------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeysPerLane = 16;  // N <= 512

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, long long stride_w, long long stride_n,
                  const float* __restrict__ bias, const float* __restrict__ mask,
                  T* __restrict__ out, int n, int heads, int num_windows,
                  int batch, float scale) {
  constexpr int DS = D + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + n * DS;

  const int blk = blockIdx.x;
  const int h = blk % heads;
  const int t = blk / heads;
  const int b = t % batch;
  const int w = t / batch;
  const long long bw = static_cast<long long>(b) * num_windows + w;
  const long long base = bw * stride_w + static_cast<long long>(h) * D;

  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    const long long off = base + j * stride_n + d;
    ks[j * DS + d] = to_f32(k[off]);
    vs[j * DS + d] = to_f32(v[off]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h = bias + static_cast<long long>(h) * n * n;
  const float* mask_w = mask ? mask + static_cast<long long>(w) * n * n : nullptr;
  T* out_bw = out + bw * n * heads * D;

  for (int i = warp; i < n; i += kWarps) {
    float qr[D];
    const T* qrow = q + base + i * stride_n;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qrow[d]) * scale;

    const float* brow = bias_h + static_cast<long long>(i) * n;
    const float* mrow = mask_w ? mask_w + static_cast<long long>(i) * n : nullptr;
    float s[kMaxKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int tt = 0; tt < kMaxKeysPerLane; ++tt) {
      s[tt] = -INFINITY;
      const int j = lane + 32 * tt;
      if (j < n) {
        const float4* kr = reinterpret_cast<const float4*>(ks + j * DS);
        float acc = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4)
          acc = dot4(make_float4(qr[4 * d4], qr[4 * d4 + 1], qr[4 * d4 + 2], qr[4 * d4 + 3]),
                     kr[d4], acc);
        acc += brow[j];
        if (mrow) acc += mrow[j];
        s[tt] = acc;
        m = fmaxf(m, acc);
      }
    }
    m = warp_max(m);

    float l = 0.f;
    float o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = 0.f;
#pragma unroll
    for (int tt = 0; tt < kMaxKeysPerLane; ++tt) {
      const int j = lane + 32 * tt;
      if (j < n) {
        const float p = __expf(s[tt] - m);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + j * DS);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          o[4 * d4] = fmaf(p, vv.x, o[4 * d4]);
          o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
          o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
          o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
        }
      }
    }
    l = warp_sum(l);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    T* orow = out_bw + (static_cast<long long>(i) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float od = warp_sum(o[d]);
      if ((d & 31) == lane) orow[d] = from_f32<T>(od * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, long long stride_w,
                   long long stride_n, const float* bias, const float* mask, void* out,
                   int bw, int n, int heads, int num_windows, float scale, dim3 grid, int smem,
                   cudaStream_t stream) {
  if (grid.x != static_cast<unsigned>(bw * heads) || grid.y != 1 ||
      smem != 2 * n * (D + 4) * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  auto kernel = window_mha_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int batch = bw / num_windows;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      stride_w, stride_n, bias, mask, static_cast<T*>(out), n, heads, num_windows, batch,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                              long long stride_w, long long stride_n, const float* bias,
                              const float* mask, void* out, int bw, int n, int heads,
                              int num_windows, float scale, dim3 grid, int smem,
                              cudaStream_t stream) {
#define ORGANSEG_CASE(DIM)                                                                \
  case DIM:                                                                               \
    return launch<T, DIM>(q, k, v, stride_w, stride_n, bias, mask, out, bw, n, heads,     \
                          num_windows, scale, grid, smem, stream);
  switch (d) {
    ORGANSEG_CASE(8)
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(24)
    ORGANSEG_CASE(32)
    ORGANSEG_CASE(40)
    ORGANSEG_CASE(48)
    ORGANSEG_CASE(56)
    ORGANSEG_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}

}  // namespace
}  // namespace organseg

// Every entry takes the launch plan of ops/window_attention.py::plan and
// refuse one that differs from the kernel's own
// (cudaErrorInvalidConfiguration).
//
// q, k, v: [BW, N, H, D] views sharing strides (stride_w between windows,
// stride_n between tokens, H*D-contiguous heads); bias [H, N, N] f32;
// mask [num_windows, N, N] f32 or null; out: contiguous [BW, N, H, D].

// f32 route: float32 or bf16, D in 8..64 step 8, N <= 512.
extern "C" int window_mha_fwd(const void* q, const void* k, const void* v,
                              long long stride_w, long long stride_n, const void* bias,
                              const void* mask, void* out, int bw, int n, int heads, int d,
                              int num_windows, float scale, int dtype, int grid_x, int grid_y,
                              int smem, int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  if (dtype == kFloat32)
    return dispatch_head_dim<float>(d, q, k, v, stride_w, stride_n, b, m, out, bw, n, heads,
                                    num_windows, scale, grid, smem, s);
  if (dtype == kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(d, q, k, v, stride_w, stride_n, b, m, out, bw, n,
                                            heads, num_windows, scale, grid, smem, s);
  return cudaErrorInvalidValue;
}

// wgmma route, bf16 only: D in 16..64 step 16, N <= 256, q/k/v pointers
// and strides 16-byte aligned; each block one (head, window position)
// walking tiles_per_block tiles through a ring of `stages` stages;
// scale_log2 = D^-1/2 * log2(e).
extern "C" int window_mha_fwd_wgmma(const void* q, const void* k, const void* v,
                                    long long stride_w, long long stride_n, const void* bias,
                                    const void* mask, void* out, int bw, int n, int heads, int d,
                                    int num_windows, float scale_log2, int tiles_per_block,
                                    int stages, int grid_x, int grid_y, int threads, int smem,
                                    int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (n < 1 || n > 256 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v)) % 16 ||
      stride_w % 8 || stride_n % 8)
    return cudaErrorInvalidValue;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
#define ORGANSEG_CASE(DIM)                                                                    \
  case DIM:                                                                                   \
    return dispatch_key_tiles<DIM>(q, k, v, stride_w, stride_n, b, m, out, bw, n, heads,      \
                                   num_windows, scale_log2, tiles_per_block, stages, grid,    \
                                   threads, smem, s);
  switch (d) {
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(32)
    ORGANSEG_CASE(48)
    ORGANSEG_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}

// mma route, bf16 only: D in 16..64 step 16, q/k/v pointers and strides
// 16-byte aligned; warps (1..8) x 16 query rows a block, each block walking
// tiles_per_block tiles; scale_log2 = D^-1/2 * log2(e).
extern "C" int window_mha_fwd_mma(const void* q, const void* k, const void* v,
                                  long long stride_w, long long stride_n, const void* bias,
                                  const void* mask, void* out, int bw, int n, int heads, int d,
                                  int num_windows, float scale_log2, int warps,
                                  int tiles_per_block, int grid_x, int grid_y, int smem,
                                  int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
#define ORGANSEG_CASE(DIM)                                                                 \
  case DIM:                                                                                \
    return launch_mma<DIM>(q, k, v, stride_w, stride_n, b, m, out, bw, n, heads,           \
                           num_windows, scale_log2, warps, tiles_per_block, grid, smem, s);
  switch (d) {
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(32)
    ORGANSEG_CASE(48)
    ORGANSEG_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}
