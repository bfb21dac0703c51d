// Shared-memory row helpers for K1's and K2's per-(row, head) attention
// kernels. A row-head's q, k, v (and dattn) live in shared memory as f32 rows
// of hd4 = hd rounded up to 4 values (zero-filled past hd) at a pitch of
// hd4 + 4 floats: rows start on 16 bytes, so products read them as float4,
// and eight consecutive rows fall in distinct banks. Each dot product and
// each row update runs over the columns in ascending order.
#pragma once

#include <cuda_bf16.h>

#include "tc_gemm.cuh"

namespace {

__host__ __device__ __forceinline__ int padded_head_dim(int hd) { return (hd + 3) & ~3; }
__host__ __device__ __forceinline__ int row_pitch(int hd) { return padded_head_dim(hd) + 4; }

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// dst[a][c] = src[a * ld_src + c] for a < n, c < hd; 0 for hd <= c < hd4.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* __restrict__ src,
                                          size_t ld_src, int n, int hd, int nthreads) {
  const int hd4 = padded_head_dim(hd);
  for (int i = threadIdx.x; i < n * hd4; i += nthreads) {
    const int a = i / hd4, c = i - a * hd4;
    dst[a * pitch + c] = c < hd ? as_float(src[a * ld_src + c]) : 0.f;
  }
}

// sum_c a[c] * b[c] over hd4 columns, in column order.
__device__ __forceinline__ float dot_rows(const float* a, const float* b, int hd4) {
  float s = 0.f;
  for (int c = 0; c < hd4; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// acc += w * row[0..4)
__device__ __forceinline__ void axpy4(float4& acc, float w, const float* row) {
  const float4 r = *reinterpret_cast<const float4*>(row);
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
  acc.z = fmaf(w, r.z, acc.z);
  acc.w = fmaf(w, r.w, acc.w);
}

// Stores the first min(4, hd - c) values of v at dst[0..], converted to T.
template <typename T>
__device__ __forceinline__ void store4(T* dst, int c, int hd, float4 v, float scale = 1.f) {
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c + t < hd) {
      if constexpr (sizeof(T) == 2)
        dst[t] = __float2bfloat16(a[t] * scale);
      else
        dst[t] = a[t] * scale;
    }
}

// The resident CUDA-core kernels hold a row-head's whole rows in shared
// memory (A <= 64, head dim <= 128). Past that, the tiled kernels walk
// chunks of queries and keys and, for head dims past kColChunk, chunks of
// columns: a logit is summed over the column chunks in order (each chunk in
// column order), and each output column chunk is accumulated on its own,
// the logits recomputed for it. Their shared memory does not grow with A or
// the head dim, so they take any A >= 1 and any head dim.
constexpr int kResidentA = 64;
constexpr int kResidentHeadDim = 128;
constexpr int kColChunk = 128;

__host__ __device__ __forceinline__ bool resident_attention(int A, int hd) {
  return A <= kResidentA && hd <= kResidentHeadDim;
}
// columns staged at a time: the whole padded row up to kColChunk
__host__ __device__ __forceinline__ int col_chunk(int hd) {
  return padded_head_dim(hd) < kColChunk ? padded_head_dim(hd) : kColChunk;
}

// The tensor-core path (bf16, A <= 64, head dim a multiple of 16): a
// row-head's q, k, v (and dattn) rows are staged in shared memory as bf16 at
// a pitch of hd + 8 (16-byte rows, ldmatrix without bank conflicts), A padded
// to a multiple of 16 with zero rows. One warp takes 16 queries (or keys).
constexpr int kMmaMaxA = 64;
constexpr int kMmaMaxHeadDim = 128;

__host__ __device__ __forceinline__ bool mma_attention(int A, int hd) {
  return A <= kMmaMaxA && hd % 16 == 0 && hd <= kMmaMaxHeadDim;
}
__host__ __device__ __forceinline__ int pad16(int a) { return (a + 15) & ~15; }

// Stages rows [0, A) of `n` hd-wide column blocks of a (tokens, ld) bf16
// array (block b starts at column offs[b]) into dst + b * a16 * (hd + 8),
// zero-filling rows [A, a16), with 16-byte copies; commits one group.
template <int N>
__device__ __forceinline__ void stage_rows_bf16(tc::bf16* dst, const tc::bf16* src, size_t ld,
                                                const int (&offs)[N], int A, int a16, int hd) {
  // thread -> (row offset, 16-byte piece) once; then a loop over rows
  const int chunks = hd / 8, ldh = hd + 8;
  const int rows_per_pass = blockDim.x / chunks;
  const int r = threadIdx.x / chunks, c = (threadIdx.x - r * chunks) * 8;
  if (r < rows_per_pass) {
#pragma unroll
    for (int b = 0; b < N; ++b)
      for (int a = r; a < a16; a += rows_per_pass) {
        const bool ok = a < A;
        const tc::bf16* s = ok ? src + a * ld + offs[b] + c : src;
        tc::cp_async16(dst + (b * a16 + a) * ldh + c, s, ok);
      }
  }
  tc::cp_async_commit();
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// acc[n] (16 x 8 tiles, n < nt) += A (16 x 16k, fragments a[k]) . B where B
// (k x n) is read from shared memory rows: b_rows_are_k selects B stored
// [k][n] (ldmatrix .trans) against [n][k]. kt k-steps of 16.
template <int NT>
__device__ __forceinline__ void mma_row_tile(float (&acc)[NT][4], const unsigned (&a)[4],
                                             const tc::bf16* b, int ldb, int k0, int nt,
                                             bool b_rows_are_k) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j >= nt) break;
    unsigned r[4];
    if (b_rows_are_k)
      tc::ldmatrix_x4_trans(r, b + (k0 + r8 + (q & 1) * 8) * ldb + j * 8 + (q >> 1) * 8);
    else
      tc::ldmatrix_x4(r, b + (j * 8 + r8 + (q >> 1) * 8) * ldb + k0 + (q & 1) * 8);
    tc::mma_bf16(acc[j], a, r[0], r[1]);
    tc::mma_bf16(acc[j + 1], a, r[2], r[3]);
  }
}

// The A fragment of rows m0 .. m0 + 16, columns k0 .. k0 + 16 of a matrix in
// shared memory, stored [m][k] (or, transposed, [k][m]).
__device__ __forceinline__ void load_a_frag(unsigned (&a)[4], const tc::bf16* m, int ld, int m0,
                                            int k0, bool stored_km) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  if (stored_km)
    tc::ldmatrix_x4_trans(a, m + (k0 + r8 + (q >> 1) * 8) * ld + m0 + (q & 1) * 8);
  else
    tc::ldmatrix_x4(a, m + (m0 + r8 + (q & 1) * 8) * ld + k0 + (q >> 1) * 8);
}

// The A fragment for k-step kt from 16 x 8 accumulator tiles 2 kt, 2 kt + 1
// (the accumulator layout of two n-tiles is the A layout of one k-step),
// rounded to bf16.
template <int NT>
__device__ __forceinline__ void acc_to_a_frag(unsigned (&a)[4], const float (&acc)[NT][4],
                                              int kt) {
  a[0] = pack_bf16(acc[2 * kt][0], acc[2 * kt][1]);
  a[1] = pack_bf16(acc[2 * kt][2], acc[2 * kt][3]);
  a[2] = pack_bf16(acc[2 * kt + 1][0], acc[2 * kt + 1][1]);
  a[3] = pack_bf16(acc[2 * kt + 1][2], acc[2 * kt + 1][3]);
}

}  // namespace
