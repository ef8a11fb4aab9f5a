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
// Two routes, chosen by the wrapper (ops/flash_attention.py::plan):
//
// mma (bf16, D a multiple of 16 up to 128): FlashAttention-2 on mma.sync
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

namespace organseg {
namespace {

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

// Both entries take the launch plan of ops/flash_attention.py::plan
// (grid_x, grid_y, dynamic shared-memory bytes) and refuse one that
// differs from the kernel's own (cudaErrorInvalidConfiguration).

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
