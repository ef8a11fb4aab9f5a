// Kernel C: SAME 3x3x3 convolution, stride 1, no bias, channels-last.
//   x [B, D, H, W, C] . w [3, 3, 3, C, Cout] -> out [B, D, H, W, Cout]
// with f32 accumulation and the output in x's dtype.
//
// Replaces the TPU kernel scripts/proto_conv_kernel.py::_kernel (launched by
// conv3x3x3_pallas). Same function and the same idea, each halo tile of the
// input is read once and all 27 taps are taken from fast memory, but not the
// same blocks: the 128-lane channel padding, the padded copy of x in device
// memory and the kw taps packed into the matmul's N are the TPU's needs. Here
// the zero padding is a bounds check while the tile is staged, and channels
// need only be multiples of 8 (one 16-byte load).
//
// What bounds it on an H100: 2*27*C*Cout flops per output voxel on
// 2*(C + Cout) bytes, 1390 flop/byte at 96 -> 48 channels, far above the
// card's 295 flop/byte: the bf16 tensor-core rate bounds it, not bytes.
//
// Design (bf16): an implicit GEMM on mma.sync m16n8k16 tensor-core tiles.
//  * one block of 8 warps per 4 x 8 x 16 (D, H, W) output tile and 48 output
//    channels (blockIdx.y walks wider Cout); M = 512 voxels: each warp owns
//    four rows of 16 voxels along W, so one tap's A operand for a row is 16
//    consecutive voxels of the halo tile;
//  * the block walks C in chunks of 16 (the mma depth): it stages the chunk
//    of the 6 x 10 x 18 halo tile and of all 27 taps' weights in shared
//    memory, then runs 27 taps x 4 rows x 6 column tiles of mma on them,
//    f32 sums staying in registers across chunks;
//  * shared rows (one voxel's, or one output channel's, 16 channels) are
//    padded from 32 to 48 bytes, which makes the fragment loads of the eight
//    rows a warp reads together conflict-free;
//  * the weights arrive as [27, Cout, C] (the wrapper re-lays the small
//    weight tensor), so a B fragment's two k-neighbours are one 32-bit load.
// Loads and math are not overlapped yet (two barriers a chunk); wgmma, TMA
// and a ring of stages are later work.
//
// f32 takes a plain direct kernel on the f32 pipes: one thread per output
// voxel and 8 output channels, inputs through L1/L2. It exists for exact
// checks at small shapes, not for speed.
#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace organseg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTD = 4, kTH = 8, kTW = 16;           // output tile (voxels)
constexpr int kPD = kTD + 2, kPH = kTH + 2, kPW = kTW + 2;  // halo tile
constexpr int kHalo = kPD * kPH * kPW;              // 1080 voxels
constexpr int kKC = 16;                             // channels per chunk (mma k)
constexpr int kRow = 24;                            // padded row, in bf16 (48 bytes)
constexpr int kNB = 48;                             // output channels per block
constexpr int kNT = kNB / 8;                        // n8 column tiles per block
constexpr int kMT = kTD * kTH / kWarps;             // m16 rows of voxels per warp (4)
constexpr int kTaps = 27;
constexpr int kSmemBytes = (kHalo + kTaps * kNB) * kRow * static_cast<int>(sizeof(__nv_bfloat16));

__global__ void __launch_bounds__(kThreads)
conv3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  __nv_bfloat16* __restrict__ out, int D, int H, int W, int C, int Cout,
                  int tiles_d, int tiles_h, int tiles_w) {
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem16);  // [kHalo][kRow]
  __nv_bfloat16* ws = xs + kHalo * kRow;                         // [27][kNB][kRow]

  int tile = blockIdx.x;
  const int tw = tile % tiles_w; tile /= tiles_w;
  const int th = tile % tiles_h; tile /= tiles_h;
  const int td = tile % tiles_d;
  const int b = tile / tiles_d;
  const int d0 = td * kTD, h0 = th * kTH, w0 = tw * kTW;
  const int n0 = blockIdx.y * kNB;
  const int nt_active = min(kNT, (Cout - n0) / 8);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row / column
  const int t = lane & 3;   // fragment k pair

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const long long x_batch = static_cast<long long>(b) * D * H * W * C;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous chunk's fragment reads are done
    // the halo tile's chunk: two 16-byte halves per voxel, zeros outside x
    for (int e = threadIdx.x; e < kHalo * 2; e += kThreads) {
      const int pos = e >> 1, half = e & 1;
      const int pw = pos % kPW;
      const int ph = (pos / kPW) % kPH;
      const int pd = pos / (kPW * kPH);
      const int zd = d0 + pd - 1, zh = h0 + ph - 1, zw = w0 + pw - 1;
      const int c = c0 + half * 8;
      uint4 val = zero;
      if (zd >= 0 && zd < D && zh >= 0 && zh < H && zw >= 0 && zw < W && c < C) {
        const long long off = x_batch + ((static_cast<long long>(zd) * H + zh) * W + zw) * C + c;
        val = *reinterpret_cast<const uint4*>(x + off);
      }
      *reinterpret_cast<uint4*>(xs + pos * kRow + half * 8) = val;
    }
    // the chunk of every tap's weights for this block's output channels
    for (int e = threadIdx.x; e < kTaps * kNB * 2; e += kThreads) {
      const int row = e >> 1, half = e & 1;
      const int n = row % kNB;
      const int tap = row / kNB;
      const int c = c0 + half * 8;
      uint4 val = zero;
      if (n0 + n < Cout && c < C) {
        const long long off = (static_cast<long long>(tap) * Cout + n0 + n) * C + c;
        val = *reinterpret_cast<const uint4*>(wt + off);
      }
      *reinterpret_cast<uint4*>(ws + row * kRow + half * 8) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int row = warp * kMT + m;  // row of 16 voxels: (d, h) in the tile
        const int d = row / kTH, h = row % kTH;
        const int base = ((d + kd) * kPH + (h + kh)) * kPW + kw;
        const __nv_bfloat16* p = xs + (base + g) * kRow + 2 * t;
        a[m][0] = *reinterpret_cast<const uint32_t*>(p);
        a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 8);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt_active) {
          const __nv_bfloat16* p = ws + ((tap * kNB) + n * 8 + g) * kRow + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
          for (int m = 0; m < kMT; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
        }
      }
    }
  }

  // c fragment: rows g and g+8 of the 16 voxels, columns 2t and 2t+1
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int row = warp * kMT + m;
    const int zd = d0 + row / kTH, zh = h0 + row % kTH;
    if (zd >= D || zh >= H) continue;
    const long long line = ((static_cast<long long>(b) * D + zd) * H + zh) * W;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n >= nt_active) continue;
      const int col = n0 + n * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int zw = w0 + g + 8 * r;
        if (zw >= W) continue;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[m][n][2 * r], acc[m][n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (line + zw) * Cout + col) = v;
      }
    }
  }
}

// f32: one thread per output voxel and 8 output channels.
__global__ void __launch_bounds__(kThreads)
conv3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                 float* __restrict__ out, int B, int D, int H, int W, int C, int Cout) {
  const int groups = Cout / 8;
  const long long total = static_cast<long long>(B) * D * H * W * groups;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int n0 = static_cast<int>(idx % groups) * 8;
  long long pos = idx / groups;
  const int zw = static_cast<int>(pos % W); pos /= W;
  const int zh = static_cast<int>(pos % H); pos /= H;
  const int zd = static_cast<int>(pos % D);
  const int b = static_cast<int>(pos / D);

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < kTaps; ++tap) {
    const int sd = zd + tap / 9 - 1, sh = zh + (tap / 3) % 3 - 1, sw = zw + tap % 3 - 1;
    if (sd < 0 || sd >= D || sh < 0 || sh >= H || sw < 0 || sw >= W) continue;
    const float* xp = x + (((static_cast<long long>(b) * D + sd) * H + sh) * W + sw) * C;
    const float* wp = wt + (static_cast<long long>(tap) * Cout + n0) * C;
    for (int c = 0; c < C; ++c) {
      const float xv = xp[c];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, wp[j * C + c], acc[j]);
    }
  }
  float* op = out + (idx / groups) * Cout + n0;
#pragma unroll
  for (int j = 0; j < 8; ++j) op[j] = acc[j];
}

}  // namespace
}  // namespace organseg

// x: contiguous [B, D, H, W, C]; wt: contiguous [27, Cout, C] (tap-major, the
// taps in (kd, kh, kw) order); out: contiguous [B, D, H, W, Cout]. C and Cout
// are multiples of 8 and every pointer is 16-byte aligned.
extern "C" int conv3x3x3_fwd(const void* x, const void* wt, void* out, int b, int d, int h,
                             int w, int c, int cout, int dtype, int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (c % 8 || cout % 8 || b < 1 || d < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const int tiles_d = (d + kTD - 1) / kTD, tiles_h = (h + kTH - 1) / kTH,
              tiles_w = (w + kTW - 1) / kTW;
    const long long blocks = static_cast<long long>(b) * tiles_d * tiles_h * tiles_w;
    if (blocks > 2147483647LL || (cout + kNB - 1) / kNB > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(blocks), (cout + kNB - 1) / kNB);
    conv3_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
        static_cast<__nv_bfloat16*>(out), d, h, w, c, cout, tiles_d, tiles_h, tiles_w);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    const long long total = static_cast<long long>(b) * d * h * w * (cout / 8);
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    conv3_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
        b, d, h, w, c, cout);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
