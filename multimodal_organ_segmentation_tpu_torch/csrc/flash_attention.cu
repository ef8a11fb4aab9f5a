// Kernel B: non-causal flash-attention forward over [B, N, H, D] tokens,
// no bias, query and key lengths may differ.
//
// Replaces the TPU kernel multimodal_organ_segmentation_tpu/ops/pallas/
// flash_attention.py::_flash_kernel (launched by _flash_forward, public
// flash_attention). Same function: out = softmax(q.k^T * D^-1/2) . v per
// (batch, head), with a running max and denominator across key blocks,
// padded keys masked out of scores and probabilities, one normalisation at
// the end, f32 sums and the output in q's dtype.
//
// What bounds it on an H100: 4*Nq*Nk*D flops on (Nq + 2*Nk)*D inputs. At
// the fusion shapes (D = 96; N = 1728, 216 and 27 tokens, 15 tiles a
// serving chunk) that is 3.6e10 flops on 36 MB: the bf16 tensor-core rate
// bounds it, 0.036 ms a chunk at 989 TFLOP/s; the bytes take 0.011 ms and
// the Nq*Nk exponentials 0.03 ms on the special-function units.
//
// Three routes, chosen by the wrapper (ops/flash_attention.py::plan):
//
// wgmma (bf16, D a multiple of 16 up to 128, from 2^20 query-key pairs):
//  FlashAttention-3-shaped, on Hopper's warpgroup products fed by TMA:
//  * one block of 384 threads owns 128 query rows of one (batch, head):
//    two consumer warpgroups of 64 rows and one producer warpgroup, which
//    gives its registers to the consumers (setmaxnreg 40 / 232);
//  * one producer thread loads the Q tile once by TMA, then streams K and
//    V tiles of 128 keys into a ring of 3 stages under full / empty
//    mbarriers. Every tile lands as [D/8][rows][8] (one box per 8-dim
//    group), the no-swizzle core-matrix layout that wgmma reads: K-major
//    for Q and K, MN-major (imm-trans-b) for V's [key][dim] rows as they
//    are. Keys past Nk arrive as zero rows (the tensor map's bounds) and
//    take -inf scores;
//  * S = Q.K^T is D/16 wgmma m64n128k16 from shared memory; the online
//    softmax runs on the accumulators in the log2 domain with the plain
//    version's running-max guard; P is rounded to bf16 in registers and is
//    the A operand (from registers) of O += P.V, eight m64nDk16; O is
//    normalised once at the end;
//  * up to D = 64, where the exponentials weigh most, the softmax overlaps
//    products twice over: a warpgroup issues tile j's S with tile j-1's
//    P.V and runs tile j's softmax while that P.V is in flight, and the two
//    warpgroups take turns on named barriers to issue their products
//    (FlashAttention-3's ping-pong). At D = 96 and 128 the products weigh
//    most: there both measured slower on the H100 than the plain order (S,
//    softmax, P.V), which the head dims from 80 take
//    (scripts/attention_variants.py). The overlap also needs a thread's S,
//    P and O at once: at D = 96 and 128 that overflowed the 168 registers
//    ptxas gives a thread of this block, and it serialized every wgmma.
//
// mma (bf16 below 2^20 query-key pairs, where a call is a few microseconds
//  and the wgmma route's 128-row blocks are too few; and the route the
//  wgmma one replaced): FlashAttention-2 on mma.sync
//  m16n8k16 tensor-core tiles, so the products run at the tensor-core rate
//  and not on the f32 pipes:
//  * one block of 4 warps owns 64 query rows of one (batch, head); each warp
//    owns 16 rows, held as D/16 A fragments in registers for the whole pass
//    (staged once through the second K/V buffer, so a block needs 53 KB at
//    D = 96 and four blocks, 16 warps, fit an SM). Two m16 row tiles a warp
//    (half the ldmatrix traffic a product) took 255 registers and two
//    blocks an SM, and were no faster;
//  * K and V tiles of 64 keys stream through shared memory by 16-byte
//    cp.async, double-buffered: tile j+1 loads while tile j computes. Rows
//    are padded to D+8 elements, which puts the eight rows of every
//    ldmatrix on eight different 16-byte bank groups (no conflicts);
//  * S = Q.K^T is 8 m16n8 accumulators a warp; the online softmax runs on
//    those registers in the log2 domain (scale * log2(e) folded in, one
//    ex2 a score), with the running-max guard of the plain version (a row
//    whose keys so far are all padding keeps m = -inf); padded keys of the
//    last tile are -inf in the scores, zero rows in K and V (cp.async zero
//    fill), and their 16-key steps are skipped;
//  * P is converted in registers into the A fragments of P.V (P rounded to
//    bf16 there, as in any tensor-core attention) and never touches shared
//    memory; O is a 16 x D f32 accumulator a warp, normalised once at the
//    end.
//
// f32 (float32, and bf16 at other head dims): the first version, on the
// f32 FMA pipes, kept for exact checks:
//  * one block of 8 warps per (batch*head, 64-query tile); the query tile is
//    staged once in shared memory as f32 (pre-scaled), then the block walks
//    64-key tiles of K and V through shared memory;
//  * each warp owns 8 query rows and each lane 2 keys of the tile for the
//    scores (K rows padded to D+4 floats: conflict-free float4 reads), and
//    ceil(D/32) output dims for P.V (V rows read one float per lane);
//  * the running max starts at -inf and is guarded as in the plain
//    blockwise_attention, so no -inf - -inf is taken;
//  * probabilities go through shared memory laid out [key][row] so the P.V
//    loop reads the 8 rows of one key as two float4 broadcasts.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace organseg {
namespace {

// ---- wgmma route -------------------------------------------------------

constexpr int kWgRows = 128;              // query rows a block: two consumer warpgroups of 64
constexpr int kWgStages = 3;              // K/V tiles in flight
constexpr int kWgConsumerWarps = 8;
constexpr int kWgThreads = 384;           // + the producer warpgroup
constexpr int kWgBars = 8 * (1 + 2 * kWgStages);

constexpr int kWgKeys = 128;              // keys a K/V tile (the n of S = Q.K^T)
// Head dims up to which the consumers overlap their softmax with products
// (the softmax-bound schedule, below); from 80 they take the plain one.
constexpr int kWgOverlapMaxD = 64;

constexpr int wgmma_smem_bytes(int d) {
  // Q [d/8][128][8], then the ring of K and V tiles [d/8][keys][8] each,
  // then the barriers; 128 bytes of slack to align the base
  return kWgRows * d * 2 + kWgStages * 2 * kWgKeys * d * 2 + kWgBars + 128;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                       int nq, int nk, int heads, float scale_log2) {
  constexpr int G = D / 8;                       // 8-dim groups: the TMA boxes of a tile
  constexpr int KEYS = kWgKeys;
  constexpr int NS = KEYS / 2;                   // a thread's scores of a tile
  constexpr int KS = KEYS / 16;                  // k16 steps of P.V
  constexpr int kQBytes = kWgRows * D * 2;
  constexpr int kTileBytes = KEYS * D * 2;    // one K or V tile
  constexpr int kStageBytes = 2 * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t ring = qs + kQBytes;
  const uint32_t bars = ring + kWgStages * kStageBytes;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kWgStages + s); };

  const int q0 = blockIdx.x * kWgRows;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int tiles = (nk + KEYS - 1) / KEYS;
  // the warp index through a shuffle: provably warp-uniform, so ptxas does
  // not treat the wgmma path as divergent (which would serialize the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);                  // the producer's arrive + the copies' bytes
      mbar_init(empty(s), kWgConsumerWarps);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kWgConsumerWarps) {
    // producer warpgroup: one thread loads Q once, then streams K and V
    setmaxnreg_dec<40>();
    if (warp == kWgConsumerWarps && lane == 0) {
      mbar_arrive_expect_tx(qbar, kQBytes);
      for (int g = 0; g < G; ++g) tma_load_4d(qs + g * kWgRows * 16, &qmap, qbar, 8 * g, h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kWgStages;
        mbar_wait(empty(s), ((j / kWgStages) & 1) ^ 1);
        const uint32_t st = ring + s * kStageBytes;
        mbar_arrive_expect_tx(full(s), kStageBytes);
        for (int g = 0; g < G; ++g) {
          tma_load_4d(st + g * KEYS * 16, &kmap, full(s), 8 * g, h, j * KEYS, b);
          tma_load_4d(st + kTileBytes + g * KEYS * 16, &vmap, full(s), 8 * g, h, j * KEYS, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int t2 = 2 * (lane & 3);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[KS][4];  // P of the previous tile, the A operand of its P.V

  // S = Q.K^T of tile j: D/16 k-steps of m64nKEYSk16 from stage s; Q and K
  // are K-major [d/8][rows][8] (LBO: the next 8-dim group, SBO: the next
  // 8 rows)
  auto issue_s = [&](float (&sc)[NS], int s) {
    const uint32_t ks = ring + s * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KEYS>(sc, wgmma_desc(qs + (2 * kk * kWgRows + 64 * wg) * 16, kWgRows * 16, 128),
                    wgmma_desc(ks + 2 * kk * KEYS * 16, KEYS * 16, 128), kk > 0 ? 1u : 0u);
    wgmma_commit();
  };
  // O += P.V of the tile in stage s: KEYS/16 k-steps of m64nDk16, V MN-major
  // [d/8][keys][8] (LBO: the next 8 keys, SBO: the next 8-dim group)
  auto issue_pv = [&](int s) {
    const uint32_t vs = ring + s * kStageBytes + kTileBytes;
#pragma unroll
    for (int p = 0; p < KS; ++p)
      wgmma_rs<D>(o, pa[p], wgmma_desc(vs + p * 16 * 16, 128, KEYS * 16), 1u);
    wgmma_commit();
  };
  // The online softmax of tile j's scores on rows g (r = 0) and g + 8
  // (r = 1), in place, in the log2 domain, keys at or past nk -inf, with
  // the running-max guard of the plain version (a row whose keys so far are
  // all -inf keeps m = -inf and takes 0 in its exponents): sc becomes
  // 2^(S - m), and corr O's correction factors.
  auto softmax = [&](float (&sc)[NS], int j, float (&corr)[2]) {
    const int left = nk - j * KEYS;  // score i of this lane: key 8 (i / 4) + t2 + i % 2
#pragma unroll
    for (int i = 0; i < NS; ++i)
      sc[i] = (8 * (i >> 2) + t2 + (i & 1) < left) ? sc[i] * scale_log2 : -INFINITY;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
      corr[r] = fast_exp2(m[r] - base[r]);  // 0 while m = -inf
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sc[i] = fast_exp2(sc[i] - base[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
  };
  // O *= corr, and P in bf16 into pa (the accumulator layout of n8 tiles
  // 2p and 2p+1 is the A layout of k16 step p); both pinned here, so that
  // the compiler moves none of it past the next products' issue
  auto rescale_and_pack = [&](const float (&sc)[NS], const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int p = 0; p < KS; ++p)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = 2 * p + hh;
        pa[p][2 * hh] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pa[p][2 * hh + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
    wgmma_fence_operands(o);
#pragma unroll
    for (int p = 0; p < KS; ++p) wgmma_fence_operands(pa[p]);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };

  mbar_wait(qbar, 0);
  if constexpr (D > kWgOverlapMaxD) {
    // The plain schedule: S, its softmax, then P.V, tile after tile. Where
    // the products take most of the time (from D = 80) it measures faster
    // than the overlapped one below.
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kWgStages;
      mbar_wait(full(s), (j / kWgStages) & 1);
      float sc[NS], corr[2];
      wgmma_fence();
      issue_s(sc, s);
      wgmma_wait<0>();
      wgmma_fence_operands(sc);
      softmax(sc, j, corr);
      rescale_and_pack(sc, corr);
      wgmma_fence();
      issue_pv(s);
      wgmma_wait<0>();
      wgmma_fence_operands(o);
#pragma unroll
      for (int p = 0; p < KS; ++p) wgmma_fence_operands(pa[p]);
      release(s);
    }
  } else {
    // The softmax-bound schedule (D <= 64). Tile j's S is issued with tile
    // j-1's P.V, so that the softmax of tile j runs while P.V of tile j-1
    // is in flight (P of tile j replaces P of tile j-1 in pa once that has
    // retired); and the two warpgroups take turns to issue their products
    // (named barriers 1 and 2), so that one's softmax runs while the
    // other's products do. Warpgroup 1 lets warpgroup 0 take the first
    // turn; the last turn is not handed back.
    if (wg == 1 && tiles > 1) named_barrier_arrive(1, 2 * 128);
    mbar_wait(full(0), 0);
    {
      float sc[NS], corr[2];
      wgmma_fence();
      issue_s(sc, 0);
      wgmma_wait<0>();
      wgmma_fence_operands(sc);
      softmax(sc, 0, corr);
      rescale_and_pack(sc, corr);
    }
    for (int j = 1; j < tiles; ++j) {
      const int s = j % kWgStages, sp = (j - 1) % kWgStages;
      mbar_wait(full(s), (j / kWgStages) & 1);
      float sc[NS], corr[2];
      named_barrier_sync(1 + wg, 2 * 128);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(sp);
      if (wg == 0 || j + 1 < tiles) named_barrier_arrive(2 - wg, 2 * 128);
      wgmma_wait<1>();  // S of tile j
      wgmma_fence_operands(sc);
      softmax(sc, j, corr);
      wgmma_wait<0>();  // P.V of tile j-1
      wgmma_fence_operands(o);
#pragma unroll
      for (int p = 0; p < KS; ++p) wgmma_fence_operands(pa[p]);
      release(sp);
      rescale_and_pack(sc, corr);
    }
    wgmma_fence();
    issue_pv((tiles - 1) % kWgStages);
    wgmma_wait<0>();
    wgmma_fence_operands(o);
#pragma unroll
    for (int p = 0; p < KS; ++p) wgmma_fence_operands(pa[p]);
    release((tiles - 1) % kWgStages);
  }

  // normalise and store rows g and g + 8 of this warp inside nq
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int row = row0 + 8 * r;
    if (row >= nq) continue;
    __nv_bfloat16* dst = out + ((static_cast<long long>(b) * nq + row) * heads + h) * D + t2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int nq,
                         int nk, int heads, float scale_log2, dim3 grid, int threads, int smem,
                         int stages, cudaStream_t stream) {
  if (grid.x != static_cast<unsigned>((nq + kWgRows - 1) / kWgRows) ||
      grid.y != static_cast<unsigned>(b * heads) || threads != kWgThreads ||
      smem != wgmma_smem_bytes(D) || stages != kWgStages)
    return cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  const long long row = static_cast<long long>(heads) * D;
  constexpr int KEYS = kWgKeys;
  if (encode_rows_map(encode, &qmap, q, D, heads, nq, b, row, row * nq, kWgRows) != CUDA_SUCCESS ||
      encode_rows_map(encode, &kmap, k, D, heads, nk, b, row, row * nk, KEYS) != CUDA_SUCCESS ||
      encode_rows_map(encode, &vmap, v, D, heads, nk, b, row, row * nk, KEYS) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
                                             nq, nk, heads, scale_log2);
  return cudaGetLastError();
}

// ---- mma route ---------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaRows = 64;      // query rows a block
constexpr int kMmaKeys = 64;      // keys a K/V tile

constexpr int mma_smem_bytes(int d) {
  // two buffers of a K and a V tile [64][d+8] each, bf16; the q tile is
  // staged in the second buffer before the first K/V tile is computed
  return 4 * kMmaKeys * (d + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int nq, int nk, int heads, float scale_log2) {
  constexpr int S = D + 8;   // shared row stride, elements
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ uint4 smem16[];
  // [2 buffers][K, V][64][S]; the q tile [64][S] first sits in buffer 1
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* qs = kv + 2 * kMmaKeys * S;

  const int q0 = blockIdx.x * kMmaRows;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const long long row = static_cast<long long>(heads) * D;  // token stride
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * nq * row + h * D;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * nk * row + h * D;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * nk * row + h * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // 64 rows from `src` (row r0 first) into `dst`; rows at or past `limit`
  // are zero-filled
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int limit) {
    for (int e = threadIdx.x; e < 64 * CH; e += kMmaThreads) {
      const int r = e / CH;
      const int c = e - r * CH;
      const bool in = r0 + r < limit;
      cp_async_16(dst + r * S + c * 8, src + (in ? r0 + r : 0) * row + c * 8, in);
    }
  };
  auto stage_kv = [&](int buf, int k0) {
    stage(kv + buf * 2 * kMmaKeys * S, kb, k0, nk);
    stage(kv + (buf * 2 + 1) * kMmaKeys * S, vb, k0, nk);
  };
  stage(qs, qb, q0, nq);
  stage_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_q_fragments(qf, qs + warp * 16 * S, S, lane);
  __syncthreads();  // every warp holds its q before K/V tile 1 overwrites it

  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int tiles = (nk + kMmaKeys - 1) / kMmaKeys;
  const int g2 = 2 * (lane & 3);

  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) stage_kv(buf ^ 1, (j + 1) * kMmaKeys);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();

    const __nv_bfloat16* kt = kv + buf * 2 * kMmaKeys * S;
    const int k0 = j * kMmaKeys;
    const int steps = min(4, (nk - k0 + 15) / 16);  // 16-key steps holding a key
    float s[8][4];
    qk_chunk(s, qf, kt, S, steps, lane);
    if (k0 + kMmaKeys <= nk) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    } else {  // the ragged last tile: keys at or past nk are -inf
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (k0 + 8 * n + g2 + (e & 1) < nk) ? s[n][e] * scale_log2 : -INFINITY;
    }
    softmax_pv_chunk(s, steps, m, l, o, kt + kMmaKeys * S, S, lane);
    __syncthreads();  // every warp is done with buffer `buf` before it refills
  }

  const int r0 = q0 + warp * 16;
  store_rows(o, l, out + (static_cast<long long>(b) * nq + r0) * row + h * D, row, nq - r0, lane);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int b, int nq,
                       int nk, int heads, float scale_log2, dim3 grid, int smem,
                       cudaStream_t stream) {
  if (grid.x != static_cast<unsigned>((nq + kMmaRows - 1) / kMmaRows) ||
      grid.y != static_cast<unsigned>(b * heads) || smem != mma_smem_bytes(D))
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), nq, nk, heads,
      scale_log2);
  return cudaGetLastError();
}

// ---- f32 route ---------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp (8)

int smem_bytes(int d) {
  // q tile [BQ][d] + k tile [BK][d+4] + v tile [BK][d] + probs [warps][BK][rows]
  return (kBlockQ * d + kBlockK * (d + 4) + kBlockK * d + kWarps * kBlockK * kRows) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DPL>  // DPL: output dims per lane, ceil(D / 32)
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int nq, int nk, int heads, int d, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * d;
  float* vs = ks + kBlockK * (d + 4);
  float* ps = vs + kBlockK * d;
  const int dk = d + 4;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row = static_cast<long long>(heads) * d;  // token stride
  const T* qb = q + static_cast<long long>(b) * nq * row + static_cast<long long>(h) * d;
  const T* kb = k + static_cast<long long>(b) * nk * row + static_cast<long long>(h) * d;
  const T* vb = v + static_cast<long long>(b) * nk * row + static_cast<long long>(h) * d;

  for (int e = threadIdx.x; e < kBlockQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    qs[e] = (q0 + r < nq) ? to_f32(qb[(q0 + r) * row + c]) * scale : 0.f;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* pw = ps + warp * kBlockK * kRows;  // this warp's [key][row] probabilities
  float m_run[kRows], l_run[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V reads are done (and Q is staged)
    for (int e = threadIdx.x; e < kBlockK * d; e += kThreads) {
      const int j = e / d;
      const int c = e - j * d;
      const bool in = k0 + j < nk;
      ks[j * dk + c] = in ? to_f32(kb[(k0 + j) * row + c]) : 0.f;
      vs[e] = in ? to_f32(vb[(k0 + j) * row + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* k_a = reinterpret_cast<const float4*>(ks + lane * dk);
    const float4* k_b = reinterpret_cast<const float4*>(ks + (lane + 32) * dk);
    const float4* q_w = reinterpret_cast<const float4*>(qs + warp * kRows * d);
    for (int c4 = 0; c4 < d / 4; ++c4) {
      const float4 ka = k_a[c4];
      const float4 kb4 = k_b[c4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = q_w[r * (d / 4) + c4];
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb4, s[r][1]);
      }
    }

    const bool valid_a = k0 + lane < nk;
    const bool valid_b = k0 + lane + 32 < nk;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sa = valid_a ? s[r][0] : -INFINITY;
      const float sb = valid_b ? s[r][1] : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(sa, sb)));
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float pa = valid_a ? __expf(sa - m_safe) : 0.f;
      const float pb = valid_b ? __expf(sb - m_safe) : 0.f;
      const float corr = __expf(m_run[r] - m_safe);  // exp(-inf) = 0 on the first tile
      l_run[r] = l_run[r] * corr + warp_sum(pa + pb);
      m_run[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= corr;
      pw[lane * kRows + r] = pa;
      pw[(lane + 32) * kRows + r] = pb;
    }
    __syncwarp();

    const int kmax = min(kBlockK, nk - k0);
    for (int j = 0; j < kmax; ++j) {
      float vv[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        vv[t] = c < d ? vs[j * d + c] : 0.f;
      }
      const float4 p_lo = reinterpret_cast<const float4*>(pw + j * kRows)[0];
      const float4 p_hi = reinterpret_cast<const float4*>(pw + j * kRows)[1];
      const float p[kRows] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w, p_hi.x, p_hi.y, p_hi.z, p_hi.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[r][t] = fmaf(p[r], vv[t], acc[r][t]);
    }
    __syncwarp();  // probabilities are read before the next tile overwrites them
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= nq) continue;
    const float inv = 1.f / (l_run[r] > 0.f ? l_run[r] : 1.f);
    T* orow = out + (static_cast<long long>(b) * nq + qi) * row + static_cast<long long>(h) * d;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int c = lane + 32 * t;
      if (c < d) orow[c] = from_f32<T>(acc[r][t] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int nq,
                   int nk, int heads, int d, float scale, dim3 grid, int smem,
                   cudaStream_t stream) {
  if (grid.x != static_cast<unsigned>(b * heads) ||
      grid.y != static_cast<unsigned>((nq + kBlockQ - 1) / kBlockQ) || smem != smem_bytes(d))
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), nq,
                                          nk, heads, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int b,
                              int nq, int nk, int heads, int d, float scale, dim3 grid,
                              int smem, cudaStream_t stream) {
#define ORGANSEG_CASE(N) \
  case N: return launch<T, N>(q, k, v, out, b, nq, nk, heads, d, scale, grid, smem, stream);
  switch ((d + 31) / 32) {
    ORGANSEG_CASE(1)
    ORGANSEG_CASE(2)
    ORGANSEG_CASE(3)
    ORGANSEG_CASE(4)
    ORGANSEG_CASE(5)
    ORGANSEG_CASE(6)
    ORGANSEG_CASE(7)
    ORGANSEG_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}

}  // namespace
}  // namespace organseg

// Every entry takes the launch plan of ops/flash_attention.py::plan
// (grid_x, grid_y, dynamic shared-memory bytes; for wgmma also threads and
// stages) and refuses one that differs from the kernel's own
// (cudaErrorInvalidConfiguration).

// f32 route. q: contiguous [B, Nq, H, D]; k, v: contiguous [B, Nk, H, D];
// out: contiguous [B, Nq, H, D]. D is a multiple of 4, at most 256; Nk >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int b, int nq, int nk, int heads, int d, float scale,
                                   int dtype, int grid_x, int grid_y, int smem, int device,
                                   void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  if (dtype == kFloat32)
    return dispatch_head_dim<float>(q, k, v, out, b, nq, nk, heads, d, scale, grid, smem, s);
  if (dtype == kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, out, b, nq, nk, heads, d, scale, grid,
                                            smem, s);
  return cudaErrorInvalidValue;
}

// wgmma route, bf16 only. Same layouts; D a multiple of 16, at most 128;
// q, k, v 16-byte aligned; scale_log2 = D^-1/2 * log2(e); threads, smem
// and stages are the plan's too.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                         int b, int nq, int nk, int heads, int d,
                                         float scale_log2, int grid_x, int grid_y, int threads,
                                         int smem, int stages, int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
#define ORGANSEG_CASE(D)                                                                   \
  case D:                                                                                  \
    return launch_wgmma<D>(q, k, v, out, b, nq, nk, heads, scale_log2, grid, threads, smem, \
                           stages, s);
  switch (d) {
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(32)
    ORGANSEG_CASE(48)
    ORGANSEG_CASE(64)
    ORGANSEG_CASE(80)
    ORGANSEG_CASE(96)
    ORGANSEG_CASE(112)
    ORGANSEG_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}

// mma route, bf16 only. Same layouts; D a multiple of 16, at most 128; every
// pointer 16-byte aligned; scale_log2 = D^-1/2 * log2(e).
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                       int b, int nq, int nk, int heads, int d,
                                       float scale_log2, int grid_x, int grid_y, int smem,
                                       int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
#define ORGANSEG_CASE(D) \
  case D: return launch_mma<D>(q, k, v, out, b, nq, nk, heads, scale_log2, grid, smem, s);
  switch (d) {
    ORGANSEG_CASE(16)
    ORGANSEG_CASE(32)
    ORGANSEG_CASE(48)
    ORGANSEG_CASE(64)
    ORGANSEG_CASE(80)
    ORGANSEG_CASE(96)
    ORGANSEG_CASE(112)
    ORGANSEG_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef ORGANSEG_CASE
}
