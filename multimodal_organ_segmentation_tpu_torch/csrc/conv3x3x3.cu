// Kernel C: SAME 3x3x3 convolution, stride 1, no bias, channels-last.
//   x [B, D, H, W, C] . w [3, 3, 3, C, Cout] -> out [B, D, H, W, Cout]
// with f32 accumulation and the output in x's dtype.
//
// Replaces the TPU kernel scripts/proto_conv_kernel.py::_kernel (launched by
// conv3x3x3_pallas). Same function and the same idea, each halo tile of the
// input is read once and all 27 taps are taken from fast memory, but not the
// same blocks: the 128-lane channel padding, the padded copy of x in device
// memory and the kw taps packed into the matmul's N are the TPU's needs. Here
// the zero padding comes from the TMA unit, which fills the parts of a box
// outside x with zeros, and channels need only be multiples of 8.
//
// What bounds it on an H100: 2*27*C*Cout flops per output voxel on
// 2*(C + Cout) bytes, 1390 flop/byte at 96 -> 48 channels, far above the
// card's 295 flop/byte: the bf16 tensor-core rate bounds it, not bytes.
//
// Design (bf16, route "wgmma"): an implicit GEMM on wgmma, fed by TMA
// through a ring of shared-memory stages.
//  * Work item: an 8 x 8 x 8 (D, H, W) output tile of one batch element
//    and one block of 48 output channels (M = 512 voxels, N = 48). A
//    persistent grid of one block per SM walks the items, so the ring
//    stays full across tile edges.
//  * One stage is one 16-channel chunk (the wgmma depth) of two things:
//    the 10 x 10 x 10 halo tile of x, two TMA boxes of 8 channels (one
//    per 16-byte k group, SAME padding, ragged edges and the channel tail
//    arriving as zeros), and the 27 taps' weights of the item's 48 output
//    channels, one contiguous 41,472-byte piece of the re-laid weights
//    ([Cout/48][C/16][27][2][48][8], zero-padded) brought by one
//    cp.async.bulk. 73,472 bytes a stage, three stages.
//  * Warp-specialised: warp 8 is the producer (one thread keeps the ring's
//    TMA loads in flight under full/empty mbarriers); warps 0-7 are two
//    consumer warpgroups, each owning four output d-slices (four m64 row
//    tiles of 8 h-lines x 8 w-voxels) with 4 x 24 f32 accumulators a thread.
//  * Products: per tap and row tile one wgmma m64n48k16, A and B both read
//    from shared memory through no-swizzle descriptors. A tap's A rows are
//    the halo shifted by (kd, kh, kw): a core matrix is 8 consecutive
//    w-voxels of one 8-channel group (128 contiguous bytes), its 8-row
//    groups are the halo's h-lines (SBO 160 bytes), its two k groups the
//    two TMA boxes (LBO 16,000 bytes); any shift is a 16-byte-aligned
//    start address. A consumer commits a chunk's 108 products as one
//    group and frees the previous chunk's stage once that group retires,
//    so one chunk's loads overlap the products of the two before it.
//  * Epilogue: the accumulators are rounded to bf16 and stored directly.
//
// f32 (route "f32") takes a plain direct kernel on the f32 pipes: one
// thread per output voxel and 8 output channels, inputs through L1/L2. It
// exists for exact checks at small shapes, not for speed.
//
// The host entries re-derive the launch plan of ops/conv3d.py::plan and
// refuse a different one with cudaErrorInvalidConfiguration.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

#include <cstdint>

namespace organseg {
namespace {

constexpr int kTaps = 27;

// ---- bf16 route: wgmma ------------------------------------------------

constexpr int kTile = 8;                              // output tile edge (voxels)
constexpr int kHaloEdge = kTile + 2;                  // 10
constexpr int kChunk = 16;                            // channels a stage (wgmma k)
constexpr int kGroupBytes = kHaloEdge * kHaloEdge * kHaloEdge * 16;  // one 8-channel box: 16,000
constexpr int kNB = 48;                               // output channels an item (wgmma n)
constexpr int kTapBytes = 2 * kNB * 16;               // [2][48][8] bf16: 1,536
constexpr int kWBytes = kTaps * kTapBytes;            // 41,472
constexpr int kStageBytes = 2 * kGroupBytes + kWBytes;  // 73,472
constexpr int kStages = 3;
constexpr int kConsumerGroups = 2;                    // warpgroups issuing wgmma
constexpr int kConsumerWarps = 4 * kConsumerGroups;
constexpr int kSlices = kTile / kConsumerGroups;      // m64 row tiles (d-slices) a warpgroup
constexpr int kWgmmaThreads = 32 * (kConsumerWarps + 1);  // + the producer warp: 288
// the ring, then full[kStages] and empty[kStages] mbarriers (128 bytes),
// then room to align the ring to 128 bytes
constexpr int kWgmmaSmem = kStages * kStageBytes + 128 + 128;  // 220,672
static_assert(kWgmmaSmem <= 232448, "the ring must fit in one block's shared memory");
static_assert(kStageBytes % 128 == 0 && kGroupBytes % 128 == 0, "TMA boxes need 128-byte alignment");

__global__ void __launch_bounds__(kWgmmaThreads, 1)
conv3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ out, int D, int H, int W, int Cout, int chunks,
                   int tiles_d, int tiles_h, int tiles_w, int nblocks, long long items) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  // the warp index through a shuffle: provably warp-uniform, so ptxas does
  // not treat the wgmma path as divergent (which would serialize the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                  // the producer's arrive + the copies' bytes
      mbar_init(empty(s), kConsumerWarps);    // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread walks the same items and chunks as the consumers
    if (lane != 0) return;
    int it = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      long long t = item;
      const int nb = static_cast<int>(t % nblocks); t /= nblocks;
      const int tw = static_cast<int>(t % tiles_w); t /= tiles_w;
      const int th = static_cast<int>(t % tiles_h); t /= tiles_h;
      const int td = static_cast<int>(t % tiles_d);
      const int b = static_cast<int>(t / tiles_d);
      const __nv_bfloat16* wsrc = wp + static_cast<long long>(nb) * chunks * (kWBytes / 2);
      for (int cc = 0; cc < chunks; ++cc, ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t st = ring + s * kStageBytes;
        mbar_arrive_expect_tx(full(s), kStageBytes);
        const int zw = tw * kTile - 1, zh = th * kTile - 1, zd = td * kTile - 1;
        tma_load_5d(st, &xmap, full(s), cc * kChunk, zw, zh, zd, b);
        tma_load_5d(st + kGroupBytes, &xmap, full(s), cc * kChunk + 8, zw, zh, zd, b);
        bulk_load(st + 2 * kGroupBytes, wsrc + static_cast<long long>(cc) * (kWBytes / 2), kWBytes,
                  full(s));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output d-slices wg*4 .. wg*4+3
  const int wg = warp / 4;
  float acc[kSlices][24];
#pragma unroll
  for (int m = 0; m < kSlices; ++m)
#pragma unroll
    for (int e = 0; e < 24; ++e) acc[m][e] = 0.f;

  int it = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    long long t = item;
    const int nb = static_cast<int>(t % nblocks); t /= nblocks;
    const int tw = static_cast<int>(t % tiles_w); t /= tiles_w;
    const int th = static_cast<int>(t % tiles_h); t /= tiles_h;
    const int td = static_cast<int>(t % tiles_d);
    const int b = static_cast<int>(t / tiles_d);

    for (int cc = 0; cc < chunks; ++cc, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = ring + s * kStageBytes;
      wgmma_fence();
#pragma unroll 1
      for (int tap = 0; tap < kTaps; ++tap) {
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const uint64_t db = wgmma_desc(st + 2 * kGroupBytes + tap * kTapBytes, kNB * 16, 128);
        const uint32_t scale_d = (cc > 0 || tap > 0) ? 1u : 0u;  // the item's first product overwrites
#pragma unroll
        for (int m = 0; m < kSlices; ++m) {
          const int pd = wg * kSlices + m + kd;  // halo slice of this tap
          const uint32_t a = st + ((pd * kHaloEdge + kh) * kHaloEdge + kw) * 16;
          wgmma_m64n48k16(acc[m], wgmma_desc(a, kGroupBytes, kHaloEdge * 16), db, scale_d);
        }
      }
      wgmma_commit();
      if (cc > 0) {  // the previous chunk's products have read their stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kSlices; ++m) wgmma_fence_operands(acc[m]);
    if (lane == 0) mbar_arrive(empty((it - 1) % kStages));

    // epilogue: round every accumulator to bf16 first (no accumulator is
    // touched on a divergent path), then store the pairs inside the tensor.
    // Pair 2j + r of a slice is row 16w+g+8r, columns 8j+2q, 8j+2q+1, and
    // row 16w+g+8r of a slice is voxel (h, w) = (2w + r, g).
    uint32_t packed[kSlices][12];
#pragma unroll
    for (int m = 0; m < kSlices; ++m)
#pragma unroll
      for (int e = 0; e < 12; ++e) packed[m][e] = pack_bf16(acc[m][2 * e], acc[m][2 * e + 1]);
    const int wq = warp & 3, g = lane >> 2, q = lane & 3;
    const int n0 = nb * kNB;
#pragma unroll
    for (int m = 0; m < kSlices; ++m) {
      const int zd = td * kTile + wg * kSlices + m;
      if (zd >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int zh = th * kTile + 2 * wq + r, zw = tw * kTile + g;
        if (zh >= H || zw >= W) continue;
        uint32_t* o = reinterpret_cast<uint32_t*>(
            out + ((((static_cast<long long>(b) * D + zd) * H + zh) * W + zw) * Cout + n0 + 2 * q));
#pragma unroll
        for (int j = 0; j < kNB / 8; ++j)
          if (n0 + 8 * j < Cout) o[4 * j] = packed[m][2 * j + r];
      }
    }
  }
}

// ---- f32 route ----------------------------------------------------------

constexpr int kThreads = 256;

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

// bf16, route "wgmma". x: contiguous [B, D, H, W, C]; wp: the re-laid
// weights [ceil(Cout/48)][ceil(C/16)][27][2][48][8], zero-padded;
// out: contiguous [B, D, H, W, Cout]. C and Cout are multiples of 8; x and
// wp are 16-byte aligned. grid, threads, smem, stages and nblock are the
// plan's: the launch is refused unless they are the ones derived here.
extern "C" int conv3x3x3_fwd_wgmma(const void* x, const void* wp, void* out, int b, int d, int h,
                                   int w, int c, int cout, int grid, int threads, int smem,
                                   int stages, int nblock, int device, void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (c % 8 || cout % 8 || b < 1 || d < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wp) % 16)
    return cudaErrorInvalidValue;
  const int tiles_d = (d + kTile - 1) / kTile, tiles_h = (h + kTile - 1) / kTile,
            tiles_w = (w + kTile - 1) / kTile;
  const int chunks = (c + kChunk - 1) / kChunk, nblocks = (cout + kNB - 1) / kNB;
  const long long items = static_cast<long long>(b) * tiles_d * tiles_h * tiles_w * nblocks;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (grid != (items < sms ? items : sms) || threads != kWgmmaThreads || smem != kWgmmaSmem ||
      stages != kStages || nblock != kNB)
    return cudaErrorInvalidConfiguration;

  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // x as a rank-5 tensor, innermost first: {C, W, H, D, B}; a box is one
  // 8-channel group of a 10 x 10 x 10 halo tile
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t strides[4] = {row, row * w, row * w * h, row * w * h * d};
  const cuuint32_t box[5] = {8, kHaloEdge, kHaloEdge, kHaloEdge, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  CUtensorMap xmap;
  const CUresult enc = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return cudaErrorInvalidValue;

  err = cudaFuncSetAttribute(conv3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgmmaSmem);
  if (err != cudaSuccess) return err;
  conv3_wgmma_kernel<<<grid, kWgmmaThreads, kWgmmaSmem, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(out), d, h, w,
      cout, chunks, tiles_d, tiles_h, tiles_w, nblocks, items);
  return cudaGetLastError();
}

// float32, route "f32". x: contiguous [B, D, H, W, C]; wt: contiguous
// [27, Cout, C] (tap-major, the taps in (kd, kh, kw) order); out: contiguous
// [B, D, H, W, Cout]. C and Cout are multiples of 8. grid and threads are
// the plan's.
extern "C" int conv3x3x3_fwd_f32(const void* x, const void* wt, void* out, int b, int d, int h,
                                 int w, int c, int cout, int grid, int threads, int device,
                                 void* stream) {
  using namespace organseg;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (c % 8 || cout % 8 || b < 1 || d < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * d * h * w * (cout / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (grid != blocks || threads != kThreads) return cudaErrorInvalidConfiguration;
  conv3_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
      b, d, h, w, c, cout);
  return cudaGetLastError();
}
