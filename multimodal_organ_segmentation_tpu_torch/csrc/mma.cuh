// Tensor-core and copy building blocks shared by the bf16 kernels:
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix (plain and
// transposed), 16-byte cp.async with zero fill and group commit/wait, the
// one-instruction exp2, and bf16 packing.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16, row-major: a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..),
//     a[3] (g+8, 2t+8..);
//   B 16x8, column-major: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C 16x8: c[0..1] (g, 2t..2t+1), c[2..3] (g+8, 2t..2t+1).
// An ldmatrix .x4 takes one row address from each lane: lanes 8i..8i+7 give
// the eight 16-byte rows of matrix i, and register i of every lane receives
// its (g, 2t..2t+1) pair of matrix i ((2t..2t+1, g) with .trans).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace organseg {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// 16 bytes global -> shared, bypassing L1; zeros instead when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// 2^x on the special-function unit, one instruction; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one register of bf16 (lo in the low half), round to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Max and sum over the four lanes of a quad (the lanes holding one row of
// an mma C fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One chunk of up to 8*KT keys of an online-softmax attention, for one
// warp's 16 query rows (rows g and g+8 of this lane). `s` holds the chunk's
// scores as mma C fragments, n8 tile n = keys 8n..8n+7, already in the log2
// domain (scale * log2(e) applied, bias added) and -inf where a key is
// padding; only the first `steps` 16-key steps hold keys. Updates the
// running max `m` (which starts at -inf), the lane's partial row sums `l`
// and the output fragments `o` (NT n8 tiles of head dims); `v` points at
// the chunk's first V row in shared memory, rows `stride` elements apart.
//
// The max guard is the plain blockwise version's: a row whose keys so far
// are all -inf keeps m = -inf and takes 0 in its exponents, so no
// -inf - -inf is formed. P goes from the score registers straight into the
// A fragments of P.V (the C layout of two n8 tiles is the A layout of one
// k16 step), rounded to bf16 there: P never touches shared memory. With few
// output tiles (NT <= 4) the P.V products alternate between two sets of
// accumulators, so that consecutive k16 steps do not wait on each other.
template <int NT, int KT>
__device__ __forceinline__ void softmax_pv_chunk(float (&s)[KT][4], int steps, float (&m)[2],
                                                 float (&l)[2], float (&o)[NT][4],
                                                 const __nv_bfloat16* v, int stride, int lane) {
  constexpr bool kSplit = NT <= 4;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < KT; ++n) {
    if (n / 2 < steps) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    base[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
    const float corr = fast_exp2(m[r] - base[r]);  // 0 while m = -inf
    m[r] = mx[r];
    l[r] *= corr;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][2 * r] *= corr;
      o[t][2 * r + 1] *= corr;
    }
  }
  float o2[NT][4];  // used only when kSplit
  if constexpr (kSplit) {
#pragma unroll
    for (int t = 0; t < NT; ++t) o2[t][0] = o2[t][1] = o2[t][2] = o2[t][3] = 0.f;
  }
  // V rows of each 16-key step as the B operand: .trans turns the
  // [key][dim] rows into (k = key, n = dim) fragments, two n8 tiles per
  // ldmatrix
  const __nv_bfloat16* vrow =
      v + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 8;
#pragma unroll
  for (int p = 0; p < KT / 2; ++p) {
    if (p < steps) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * p + h;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = fast_exp2(s[n][e] - base[e >> 1]);
        l[0] += s[n][0] + s[n][1];
        l[1] += s[n][2] + s[n][3];
        a[2 * h] = pack_bf16(s[n][0], s[n][1]);
        a[2 * h + 1] = pack_bf16(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + 16 * p * stride + 16 * t);
        bool odd = false;
        if constexpr (kSplit) odd = p & 1;
        if (odd) {
          mma_bf16(o2[2 * t], a, b[0], b[1]);
          mma_bf16(o2[2 * t + 1], a, b[2], b[3]);
        } else {
          mma_bf16(o[2 * t], a, b[0], b[1]);
          mma_bf16(o[2 * t + 1], a, b[2], b[3]);
        }
      }
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] += o2[t][e];
  }
}

// S = Q.K^T for one chunk of up to 8*KT keys: `q` holds the warp's 16 rows
// as KS A fragments (k16 steps of the head dim), `k` points at the chunk's
// first K row in shared memory ([key][dim], rows `stride` elements apart).
// Scores of the first `steps` 16-key steps only; the rest stay 0.
template <int KS, int KT>
__device__ __forceinline__ void qk_chunk(float (&s)[KT][4], const uint32_t (&q)[KS][4],
                                         const __nv_bfloat16* k, int stride, int steps,
                                         int lane) {
  // two n8 key tiles per ldmatrix: matrices (keys 0-7, dims 0-7),
  // (keys 0-7, dims 8-15), (keys 8-15, dims 0-7), (keys 8-15, dims 8-15)
  const __nv_bfloat16* krow =
      k + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < KT / 2; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * p][e] = s[2 * p + 1][e] = 0.f;
    if (p < steps) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, krow + 16 * p * stride + 16 * kk);
        mma_bf16(s[2 * p], q[kk], b[0], b[1]);
        mma_bf16(s[2 * p + 1], q[kk], b[2], b[3]);
      }
    }
  }
}

// The warp's 16 query rows from shared memory as A fragments, KS k16 steps.
template <int KS>
__device__ __forceinline__ void load_q_fragments(uint32_t (&q)[KS][4], const __nv_bfloat16* rows,
                                                 int stride, int lane) {
  const __nv_bfloat16* qrow = rows + (lane & 15) * stride + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(q[kk], qrow + 16 * kk);
}

// Normalise the warp's output fragments and store its rows g and g+8 that
// lie below `valid_rows`: row r goes to out + r * row_stride, dims 2t, 2t+1
// of each n8 tile as one 4-byte store.
template <int NT>
__device__ __forceinline__ void store_rows(const float (&o)[NT][4], float (&l)[2],
                                           __nv_bfloat16* out, long long row_stride,
                                           int valid_rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int row = g + 8 * r;
    if (row >= valid_rows) continue;
    __nv_bfloat16* dst = out + row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

}  // namespace organseg
