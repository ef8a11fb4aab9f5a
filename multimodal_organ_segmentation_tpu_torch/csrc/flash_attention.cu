// Kernel B: non-causal flash-attention forward over [B, N, H, D] tokens,
// no bias, query and key lengths may differ.
//
// Replaces the TPU kernel multimodal_organ_segmentation_tpu/ops/pallas/
// flash_attention.py::_flash_kernel (launched by _flash_forward, public
// flash_attention). Same function: out = softmax(q.k^T * D^-1/2) . v per
// (batch, head), with a running max and denominator across key blocks,
// padded keys masked out of scores and probabilities, one normalisation at
// the end, f32 math and the output in q's dtype.
//
// What bounds it on an H100: at the fusion shapes (D = 96; N = 1728, 216
// and 27 tokens) the kernel does 4*Nq*Nk*D flops on (Nq + 2*Nk)*D inputs,
// so arithmetic, not bytes, bounds it; a tensor-core kernel would be bound
// by the bf16 mma rate, this first version by the f32 FMA pipes.
//
// Design:
//  * one block of 8 warps per (batch*head, 64-query tile); the query tile is
//    staged once in shared memory as f32 (pre-scaled), then the block walks
//    64-key tiles of K and V through shared memory;
//  * each warp owns 8 query rows and each lane 2 keys of the tile for the
//    scores (K rows padded to D+4 floats: conflict-free float4 reads), and
//    ceil(D/32) output dims for P.V (V rows read one float per lane);
//  * the running max starts at -inf and is guarded as in the plain
//    blockwise_attention (a row whose keys so far are all padding keeps
//    m = -inf and uses 0 in its exponent), so no -inf - -inf is taken;
//  * probabilities go through shared memory laid out [key][row] so the P.V
//    loop reads the 8 rows of one key as two float4 broadcasts.
#include "common.cuh"

namespace organseg {
namespace {

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
                   int nk, int heads, int d, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(d);
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (nq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), nq,
                                          nk, heads, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int b,
                              int nq, int nk, int heads, int d, float scale,
                              cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 2: return launch<T, 2>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 3: return launch<T, 3>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 4: return launch<T, 4>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 5: return launch<T, 5>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 6: return launch<T, 6>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 7: return launch<T, 7>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    case 8: return launch<T, 8>(q, k, v, out, b, nq, nk, heads, d, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace organseg

// q: contiguous [B, Nq, H, D]; k, v: contiguous [B, Nk, H, D]; out: contiguous
// [B, Nq, H, D]. D is a multiple of 4, at most 256; Nk >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int b, int nq, int nk, int heads, int d, float scale,
                                   int dtype, int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_head_dim<float>(q, k, v, out, b, nq, nk, heads, d, scale, s);
  if (dtype == kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, out, b, nq, nk, heads, d, scale, s);
  return cudaErrorInvalidValue;
}
