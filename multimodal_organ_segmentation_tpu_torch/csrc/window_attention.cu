// Kernel A: windowed multi-head attention with relative-position bias and
// the shifted-window mask, forward only.
//
// Replaces the TPU kernel multimodal_organ_segmentation_tpu/ops/pallas/
// window_attention.py::_kernel (launched by _window_mha_fwd_impl, public
// window_mha). Same function: for every window w of every batch element and
// every head h,
//     out = softmax(q.k^T * D^-1/2 + bias[h] + mask[w]) . v
// with the math in f32 and the output in q's dtype.
//
// What bounds it on an H100: at the SwinUNETR shapes (N = 216 tokens, head
// dim D = 16) each (window, head) does 4*N*N*D flops and N*N exponentials
// on 2*N*D inputs, so it is far below the tensor cores' balance point and
// between the f32 pipes (FMA and MUFU exp) and the bytes of the shift mask,
// which is [nW, N, N] f32 (96 MB at stage 0 of a 15-tile chunk, above the
// 50 MB L2).
//
// Design:
//  * one block of 8 warps per (window, head); K and V of that pair are staged
//    once in shared memory as f32, rows padded to D+4 floats so that one
//    lane per key reads them as float4 with no bank conflicts;
//  * one warp per query row: each lane owns keys lane, lane+32, ... (at most
//    16, so N <= 512), keeps its scores in registers, and the softmax max and
//    sum are warp shuffles. Bias and mask rows are read coalesced, straight
//    from global memory, exactly once per (window, head);
//  * the block index runs head fastest, then batch element, then window, so
//    the blocks that read mask[w] (every head of window w in every tile of
//    the chunk) run close together and their repeated reads can hit in L2,
//    instead of each tile and head taking the mask from DRAM;
//  * no tensor cores yet: this first version runs on the f32 pipes, and
//    mma/wgmma tiles are later work (PERF.md has its time beside its bound).
#include "common.cuh"

namespace organseg {
namespace {

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
                   int bw, int n, int heads, int num_windows, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * n * (D + 4) * static_cast<int>(sizeof(float));
  auto kernel = window_mha_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int batch = bw / num_windows;
  kernel<<<bw * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      stride_w, stride_n, bias, mask, static_cast<T*>(out), n, heads, num_windows, batch,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                              long long stride_w, long long stride_n, const float* bias,
                              const float* mask, void* out, int bw, int n, int heads,
                              int num_windows, float scale, cudaStream_t stream) {
#define ORGANSEG_CASE(DIM)                                                                \
  case DIM:                                                                               \
    return launch<T, DIM>(q, k, v, stride_w, stride_n, bias, mask, out, bw, n, heads,     \
                          num_windows, scale, stream);
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

// q, k, v: [BW, N, H, D] views sharing strides (stride_w between windows,
// stride_n between tokens, H*D-contiguous heads); bias [H, N, N] f32;
// mask [num_windows, N, N] f32 or null; out: contiguous [BW, N, H, D].
extern "C" int window_mha_fwd(const void* q, const void* k, const void* v,
                              long long stride_w, long long stride_n, const void* bias,
                              const void* mask, void* out, int bw, int n, int heads, int d,
                              int num_windows, float scale, int dtype, int device,
                              void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_head_dim<float>(d, q, k, v, stride_w, stride_n, b, m, out, bw, n, heads,
                                    num_windows, scale, s);
  if (dtype == kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(d, q, k, v, stride_w, stride_n, b, m, out, bw, n,
                                            heads, num_windows, scale, s);
  return cudaErrorInvalidValue;
}
