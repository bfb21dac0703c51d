// Fused graph attention backward (K2) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel` of
// crowdnav_prediction_attngraph_tpu/ops/masked_attention.py (launched by
// `_fused_backward`): the gradients of K1 (fused_graph_attention.cu),
//
//   out = concat_h(softmax(q_h k_h^T / sqrt(hd) + mask) v_h) . W_out + b_out,
//   [q k v] = x . W_qkv + b_qkv,
//
// for the output cotangent g: dx, dW_qkv, db_qkv, dW_out and db_out. Like the
// TPU kernel it recomputes q, k, v and the softmax from x instead of reading
// stored probabilities, and the gradients are those of the executed forward:
// in bf16 mode x, g and the weights, the recomputed q/k/v, q x scale, the
// softmax weights P, dattn = g . W_out^T, dS, the attention output and dqkv
// are rounded to bf16 where `_bwd_kernel` casts; every product accumulates
// in f32 and the bias gradients sum f32 values. A row with no valid key has
// a zero attention output, so its dq, dk, dv and dx are exactly 0.
//
// What bounds it: ~22 T D^2 FLOP of products over T = rows x A tokens (the
// q/k/v recompute 6, dattn 2, dx 6, dW_qkv 6, dW_out 2; 110 GFLOP at
// 960 x 20, D = 512) against 12 rows A^2 D of attention (2.1% of it at
// A = 20): the tensor-core rate at large rows.
//
// Design, one launch per stage, in this order on the caller's stream:
//   1. f32 -> bf16 copies of x, g, W_qkv and W_out (bf16 mode only);
//   2. qkv = x . W_qkv + b (epilogue: round, q x scale_c, round) and
//   3. dattn = g . W_out^T, both with the tiled tensor-core product of
//      tc_gemm.cuh (the f32 mode runs its CUDA-core FMA variant);
//   4. the attention backward, one block per (row, head): in bf16 with
//      A <= 64 and head dim % 16 == 0 (the paths' shapes) every small
//      product on mma.sync; otherwise on CUDA cores, where A <= 64 with head
//      dim <= 128 keeps the row-head's q, k, v, dattn, P and dS resident and
//      computes P (softmax64.cuh), the rounded attention output, dv, dP, dS,
//      dq x scale and dk once each, and any other shape works in chunks of
//      32 queries and keys and, past head dim 128, of 128 columns: a pass
//      for each query's softmax max, sum and rowsum(dP o P), a query-side
//      pass (attention output, dq) and a key-side pass (dk, dv), one output
//      column chunk at a time, recomputing the logits each time. It writes
//      dqkv in the compute type (for the products) and, for the bias sums,
//      in f32 per token (CUDA-core kernels) or as each row's f32 sums over
//      its tokens (the tensor-core kernel of the bf16, A <= 64 case);
//   5. dx = dqkv . W_qkv^T with the same product;
//   6. dW_qkv = x^T . dqkv and dW_out = attn^T . g, one launch of the
//      product for both: their K is the token count and their outputs are
//      small, so each 128 x 64 tile's block splits its K loop over four
//      warp groups and adds their sums in group order;
//   7./8. db_qkv and db_out: column sums over 16 token slices, then the
//      slices' sums added in order.
// Device launches per call: 8 in bf16, 7 in f32. No split-K across blocks
// and no float atomics: two runs on the same inputs give the same bits.
//
// Shapes: any A >= 1, any head dim, any D that the head count divides (the
// products take rows that are not a multiple of 16 bytes by element loads,
// tc_gemm.cuh); the tiled attention keeps its per-query statistics in the
// caller's scratch, so no buffer here grows with A or the head dim.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_rows.cuh"
#include "softmax64.cuh"
#include "tc_gemm.cuh"

namespace {

using tc::bf16;

constexpr int kThreads = 128;       // resident attention kernel
constexpr int kThreadsTiled = 256;  // tiled attention kernel
constexpr int kTile = 32;           // queries / keys per chunk of the tiled kernel
// three tiled blocks an SM (~61 KB of shared memory each at head dim <=
// 64): registers capped at 85 a thread; uncapped the compiler took 128 and
// two blocks fit
constexpr int kTiledBlocksPerSM = 3;

// A <= 64, head dim <= 128: one block per (head, row) with everything
// resident.
// qkv (T, 3D): q x scale_c, k, v (rounded); da (T, D): dattn (rounded).
// Writes dqkv (T, 3D) f32, its copy in T when T is bf16 (dqkv_c), and the
// rounded attention output attn (T, D). Dot products read float4 rows;
// the products over tokens run four columns a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_backward_kernel(const T* __restrict__ qkv, const T* __restrict__ da,
                          const unsigned char* __restrict__ mask, float* __restrict__ dqkv,
                          T* __restrict__ dqkv_c, T* __restrict__ attn, int A, int D, int H,
                          float scale) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, hd4 = padded_head_dim(hd), ld = row_pitch(hd), D3 = 3 * D;
  const int n4 = hd4 / 4;
  const int h0 = blockIdx.x * hd;
  const int pld = (A + 3) & ~3;  // P's and dS's pitch
  float* qs = smem;            // A x ld
  float* ks = qs + A * ld;
  float* vs = ks + A * ld;
  float* das = vs + A * ld;
  float* ps = das + A * ld;    // A x pld: P (f32)
  float* dss = ps + A * pld;   // A x pld: dS (rounded)
  __shared__ unsigned char valid[64];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * A;
  int mine = 0;
  for (int j = tid; j < A; j += kThreads) {
    valid[j] = mask[tok0 + j] != 0;
    mine |= valid[j];
  }
  const T* base = qkv + tok0 * D3 + h0;
  load_rows(qs, ld, base, D3, A, hd, kThreads);
  load_rows(ks, ld, base + D, D3, A, hd, kThreads);
  load_rows(vs, ld, base + 2 * D, D3, A, hd, kThreads);
  load_rows(das, ld, da + tok0 * D + h0, D, A, hd, kThreads);
  const int any_valid = __syncthreads_or(mine);

  for (int idx = tid; idx < A * A; idx += kThreads) {
    const int i = idx / A, j = idx - i * A;
    ps[i * pld + j] = dot_rows(qs + i * ld, ks + j * ld, hd4);
  }
  __syncthreads();
  for (int i = warp; i < A; i += kThreads / 32)
    warp_masked_softmax64(ps + i * pld, valid, A, any_valid, 0);
  __syncthreads();

  // attention output o = P_c v (for dW_out) and dv = P_c^T da
  for (int idx = tid; idx < A * n4; idx += kThreads) {
    const int i = idx / n4, c = (idx - i * n4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f), dv = o;
    for (int j = 0; j < A; ++j) {
      axpy4(o, round_to(ps[i * pld + j], kBf16), vs + j * ld + c);
      axpy4(dv, round_to(ps[j * pld + i], kBf16), das + j * ld + c);
    }
    store4(attn + (tok0 + i) * D + h0 + c, c, hd, o);
    const size_t at = (tok0 + i) * D3 + 2 * D + h0 + c;
    store4(dqkv + at, c, hd, dv);
    if (kBf16) store4(dqkv_c + at, c, hd, dv);
  }
  // dP = da v^T and dS = P o (dP - rowsum(dP o P)), one warp per query
  for (int i = warp; i < A; i += kThreads / 32) {
    float dp[2], pr[2];
    float r = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      pr[t] = j < A ? ps[i * pld + j] : 0.f;
      dp[t] = j < A ? dot_rows(das + i * ld, vs + j * ld, hd4) : 0.f;
      r += dp[t] * pr[t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < A) dss[i * pld + j] = round_to(pr[t] * (dp[t] - r), kBf16);
    }
  }
  __syncthreads();

  // dq = dS k scale, dk = dS^T (q x scale)
  for (int idx = tid; idx < A * n4; idx += kThreads) {
    const int i = idx / n4, c = (idx - i * n4) * 4;
    float4 dq = make_float4(0.f, 0.f, 0.f, 0.f), dk = dq;
    for (int j = 0; j < A; ++j) {
      axpy4(dq, dss[i * pld + j], ks + j * ld + c);
      axpy4(dk, dss[j * pld + i], qs + j * ld + c);
    }
    const size_t at = (tok0 + i) * D3 + h0 + c;
    store4(dqkv + at, c, hd, dq, scale);
    store4(dqkv + at + D, c, hd, dk);
    if (kBf16) {
      store4(dqkv_c + at, c, hd, dq, scale);
      store4(dqkv_c + at + D, c, hd, dk);
    }
  }
}

// Any other shape (A > 64 or head dim > 128): one block per (head, row), in
// chunks of kTile queries and keys and, past head dim 128, chunks of
// col_chunk(hd) columns; the same values as the resident kernel, with the
// softmax max and sum taken over the key chunks as running values. The
// staged query chunk's max, sum and rowsum(dP o P) live in shared memory;
// each chunk's go to the caller's scratch `stats` (3 A floats a (row,
// head)) after the first pass and come back with the chunk's rows, so
// nothing here grows with A.
template <typename T>
__global__ void __launch_bounds__(kThreadsTiled, kTiledBlocksPerSM)
attention_backward_tiled_kernel(const T* __restrict__ qkv, const T* __restrict__ da,
                                const unsigned char* __restrict__ mask,
                                float* __restrict__ dqkv, T* __restrict__ dqkv_c,
                                T* __restrict__ attn, float* __restrict__ stats, int A, int D,
                                int H, float scale) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  constexpr int NT = kThreadsTiled;
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, D3 = 3 * D;
  const int cwmax = col_chunk(hd), ld = cwmax + 4;
  const int ncc = (hd + cwmax - 1) / cwmax;
  const int h0 = blockIdx.x * hd;
  float* qs = smem;                 // kTile x ld each: a column chunk of q,
  float* das = qs + kTile * ld;     // dattn, k and v
  float* ks = das + kTile * ld;
  float* vs = ks + kTile * ld;
  float* acc1 = vs + kTile * ld;    // attention output, then dv
  float* acc2 = acc1 + kTile * ld;  // dq, then dk
  float* ps = acc2 + kTile * ld;    // kTile x kTile: logits, P, P_c
  float* dps = ps + kTile * kTile;  // dP, then dS
  float* qm = dps + kTile * kTile;  // the staged queries' softmax max,
  float* ql = qm + kTile;           // sum and rowsum(dP o P)
  float* qd = ql + kTile;
  unsigned char* kvalid = reinterpret_cast<unsigned char*>(qd + kTile);
  float* m_all = stats + (static_cast<size_t>(blockIdx.y) * H + blockIdx.x) * 3 * A;
  float* l_all = m_all + A;
  float* d_all = l_all + A;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * A;
  const T* base = qkv + tok0 * D3 + h0;
  const T* da_base = da + tok0 * D + h0;
  int mine = 0;
  for (int j = tid; j < A; j += NT) mine |= mask[tok0 + j] != 0;
  const int any_valid = __syncthreads_or(mine);
  const int nb = (A + kTile - 1) / kTile;

  // With one column chunk the staged rows are reused while their chunk of
  // queries or keys stays the same; otherwise every call restages them.
  const bool one_chunk = ncc == 1;
  int staged_q0 = -1, staged_k0 = -1, stats_q0 = -1;
  auto load_q = [&](int q0, int nq, int c0, int cw) {
    load_rows(qs, ld, base + static_cast<size_t>(q0) * D3 + c0, D3, nq, cw, NT);
    load_rows(das, ld, da_base + static_cast<size_t>(q0) * D + c0, D, nq, cw, NT);
  };
  auto load_kv = [&](int k0, int nk, int c0, int cw) {
    load_rows(ks, ld, base + static_cast<size_t>(k0) * D3 + D + c0, D3, nk, cw, NT);
    load_rows(vs, ld, base + static_cast<size_t>(k0) * D3 + 2 * D + c0, D3, nk, cw, NT);
  };
  // ps = q k^T and dps = da v^T for the chunks, summed over the column
  // chunks in order; kvalid holds the keys' mask
  auto logits_dp = [&](int q0, int nq, int k0, int nk) {
    for (int cc = 0; cc < ncc; ++cc) {
      const int c0 = cc * cwmax, cw = min(cwmax, hd - c0), cw4 = padded_head_dim(cw);
      __syncthreads();  // the previous readers of the staged rows are done
      if (!one_chunk || q0 != staged_q0) load_q(q0, nq, c0, cw);
      if (q0 != stats_q0) {  // passes 2 and 3: the first pass's statistics
        for (int i = tid; i < nq; i += NT) {
          qm[i] = m_all[q0 + i];
          ql[i] = l_all[q0 + i];
          qd[i] = d_all[q0 + i];
        }
        stats_q0 = q0;
      }
      if (!one_chunk || k0 != staged_k0) {
        load_kv(k0, nk, c0, cw);
        if (cc == 0)
          for (int j = tid; j < nk; j += NT) kvalid[j] = mask[tok0 + k0 + j] != 0;
      }
      staged_q0 = q0;
      staged_k0 = k0;
      __syncthreads();
      for (int idx = tid; idx < nq * nk; idx += NT) {
        const int i = idx / nk, j = idx - i * nk;
        const float s = dot_rows(qs + i * ld, ks + j * ld, cw4);
        const float dp = dot_rows(das + i * ld, vs + j * ld, cw4);
        ps[i * kTile + j] = cc == 0 ? s : ps[i * kTile + j] + s;
        dps[i * kTile + j] = cc == 0 ? dp : dps[i * kTile + j] + dp;
      }
    }
    __syncthreads();
  };
  // P of staged query i and key j
  auto prob = [&](int i, int j, float s) {
    return (any_valid && kvalid[j]) ? expf(s - qm[i]) / ql[i] : 0.f;
  };
  // ps <- P_c and dps <- dS for the staged chunks (needs the row stats)
  auto p_and_ds = [&](int nq, int nk) {
    for (int idx = tid; idx < nq * nk; idx += NT) {
      const int i = idx / nk, j = idx - i * nk;
      const float p = prob(i, j, ps[i * kTile + j]);
      dps[i * kTile + j] = round_to(p * (dps[i * kTile + j] - qd[i]), kBf16);
      ps[i * kTile + j] = round_to(p, kBf16);
    }
  };
  // acc1 (+)= sum over `n` of w1 rows1 and acc2 (+)= w2 rows2, four
  // columns a thread over n4 float4 columns; w(x, y) reads the weight of
  // output row x, term y
  auto accumulate = [&](int nout, int n, int n4, bool first, const float* w1, int s1x,
                        int s1y, const float* rows1, const float* w2, int s2x, int s2y,
                        const float* rows2) {
    for (int idx = tid; idx < nout * n4; idx += NT) {
      const int x = idx / n4, c = (idx - x * n4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      for (int y = 0; y < n; ++y) {
        axpy4(a, w1[x * s1x + y * s1y], rows1 + y * ld + c);
        axpy4(b, w2[x * s2x + y * s2y], rows2 + y * ld + c);
      }
      float4* d1 = reinterpret_cast<float4*>(acc1 + x * ld + c);
      float4* d2 = reinterpret_cast<float4*>(acc2 + x * ld + c);
      if (!first) {
        const float4 p1 = *d1, p2 = *d2;
        a = make_float4(p1.x + a.x, p1.y + a.y, p1.z + a.z, p1.w + a.w);
        b = make_float4(p2.x + b.x, p2.y + b.y, p2.z + b.z, p2.w + b.w);
      }
      *d1 = a;
      *d2 = b;
    }
  };

  // pass 1: each query's running softmax max and sum over the key chunks,
  // then rowsum(dP o P) with the final max and sum
  for (int qb = 0; qb < nb; ++qb) {
    const int q0 = qb * kTile, nq = min(kTile, A - q0);
    __syncthreads();  // the previous chunk's statistics are written out
    for (int i = tid; i < nq; i += NT) {
      qm[i] = -INFINITY;
      ql[i] = 0.f;
      qd[i] = 0.f;
    }
    stats_q0 = q0;
    for (int kb = 0; kb < nb; ++kb) {
      const int k0 = kb * kTile, nk = min(kTile, A - k0);
      logits_dp(q0, nq, k0, nk);
      for (int i = warp; i < nq; i += NT / 32) {
        const bool ok = lane < nk && kvalid[lane];
        const float s = ok ? ps[i * kTile + lane] : -INFINITY;
        float mc = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
        const float m_old = qm[i];
        const float m_new = fmaxf(m_old, mc);
        if (m_new == -INFINITY) continue;  // no valid key yet (the whole warp)
        float sum = ok ? expf(s - m_new) : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          ql[i] = ql[i] * expf(m_old - m_new) + sum;
          qm[i] = m_new;
        }
      }
    }
    for (int kb = 0; kb < nb; ++kb) {
      const int k0 = kb * kTile, nk = min(kTile, A - k0);
      logits_dp(q0, nq, k0, nk);
      for (int i = warp; i < nq; i += NT / 32) {
        float r = lane < nk ? dps[i * kTile + lane] * prob(i, lane, ps[i * kTile + lane]) : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
        if (lane == 0) qd[i] += r;
      }
    }
    __syncthreads();
    for (int i = tid; i < nq; i += NT) {
      m_all[q0 + i] = qm[i];
      l_all[q0 + i] = ql[i];
      d_all[q0 + i] = qd[i];
    }
  }

  // pass 2, query side: attention output o = P_c v and dq = dS k scale,
  // one output column chunk at a time
  for (int qb = 0; qb < nb; ++qb) {
    const int q0 = qb * kTile, nq = min(kTile, A - q0);
    for (int oc = 0; oc < ncc; ++oc) {
      const int c0 = oc * cwmax, cw = min(cwmax, hd - c0), n4 = padded_head_dim(cw) / 4;
      for (int kb = 0; kb < nb; ++kb) {
        const int k0 = kb * kTile, nk = min(kTile, A - k0);
        logits_dp(q0, nq, k0, nk);
        p_and_ds(nq, nk);
        if (oc != ncc - 1) load_kv(k0, nk, c0, cw);  // the logits left the last chunk
        __syncthreads();
        accumulate(nq, nk, n4, kb == 0, ps, kTile, 1, vs, dps, kTile, 1, ks);
      }
      for (int idx = tid; idx < nq * n4; idx += NT) {
        const int i = idx / n4, c = (idx - i * n4) * 4;
        const float4 o = *reinterpret_cast<const float4*>(acc1 + i * ld + c);
        const float4 dq = *reinterpret_cast<const float4*>(acc2 + i * ld + c);
        store4(attn + (tok0 + q0 + i) * D + h0 + c0 + c, c, cw, o);
        const size_t at = (tok0 + q0 + i) * D3 + h0 + c0 + c;
        store4(dqkv + at, c, cw, dq, scale);
        if (kBf16) store4(dqkv_c + at, c, cw, dq, scale);
      }
    }
  }

  // pass 3, key side: dv = P_c^T da and dk = dS^T (q x scale)
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * kTile, nk = min(kTile, A - k0);
    for (int oc = 0; oc < ncc; ++oc) {
      const int c0 = oc * cwmax, cw = min(cwmax, hd - c0), n4 = padded_head_dim(cw) / 4;
      for (int qb = 0; qb < nb; ++qb) {
        const int q0 = qb * kTile, nq = min(kTile, A - q0);
        logits_dp(q0, nq, k0, nk);
        p_and_ds(nq, nk);
        if (oc != ncc - 1) load_q(q0, nq, c0, cw);
        __syncthreads();
        accumulate(nk, nq, n4, qb == 0, ps, 1, kTile, das, dps, 1, kTile, qs);
      }
      for (int idx = tid; idx < nk * n4; idx += NT) {
        const int j = idx / n4, c = (idx - j * n4) * 4;
        const float4 dv = *reinterpret_cast<const float4*>(acc1 + j * ld + c);
        const float4 dk = *reinterpret_cast<const float4*>(acc2 + j * ld + c);
        const size_t at = (tok0 + k0 + j) * D3 + h0 + c0 + c;
        store4(dqkv + at + D, c, cw, dk);
        store4(dqkv + at + 2 * D, c, cw, dv);
        if (kBf16) {
          store4(dqkv_c + at + D, c, cw, dk);
          store4(dqkv_c + at + 2 * D, c, cw, dv);
        }
      }
    }
  }
}

// out[c] (c < hd) = the sum of the scaled accumulator values over the
// block's rows below A: each warp adds its 16 rows (rows g and g + 8 of each
// lane, then across the lanes' g), then the warps' sums are added in warp
// order. Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ void sum_rows(const float (&acc)[NT][4], int m0, int A, int hd,
                                         float scale, float (*warp_sums)[kMmaMaxHeadDim],
                                         float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n * 8 >= hd) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = (m0 + g < A ? acc[n][e] * scale : 0.f) + (m0 + g + 8 < A ? acc[n][2 + e] * scale : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) warp_sums[warp][n * 8 + 2 * t + e] = v;
    }
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += warp_sums[w][c];
    out[c] = s;
  }
  __syncthreads();
}

// The tensor-core variant for bf16, A <= 64, head dim % 16 == 0 (the
// paths' shapes): one block per (head, row), one warp per 16 queries, then
// per 16 keys. Every product runs on mma.sync from the staged bf16 rows:
// S = q k^T, the softmax on S's accumulators (P stays f32), o = P_c v,
// dP = dattn v^T, dS = P o (dP - rowsum(dP o P)) rounded, dq = dS k; P_c and
// dS go to shared memory for the key side's dv = P_c^T dattn and dk =
// dS^T q. Instead of dqkv in f32, it writes the row's sums of the f32 dq,
// dk, dv over its A tokens (row_sums, (rows, 3D)) for db_qkv.
__global__ void __launch_bounds__(32 * kMmaMaxA / 16)
attention_backward_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                              const unsigned char* __restrict__ mask,
                              float* __restrict__ row_sums, bf16* __restrict__ dqkv_c,
                              bf16* __restrict__ attn, int A, int D, int H, float scale) {
  constexpr int kKeyTiles = kMmaMaxA / 8, kColTiles = kMmaMaxHeadDim / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned char valid[kMmaMaxA];
  __shared__ float warp_sums[kMmaMaxA / 16][kMmaMaxHeadDim];
  const int hd = D / H, ldh = hd + 8, a16 = pad16(A), ldp = a16 + 8, D3 = 3 * D;
  const int h0 = blockIdx.x * hd;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * A;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // a16 x ldh each: q, k, v, dattn
  bf16* ks = qs + a16 * ldh;
  bf16* vs = ks + a16 * ldh;
  bf16* das = vs + a16 * ldh;
  bf16* pcs = das + a16 * ldh;                   // a16 x ldp each: P_c, dS [query][key]
  bf16* dss = pcs + a16 * ldp;
  const int offs[3] = {h0, D + h0, 2 * D + h0};
  stage_rows_bf16(qs, qkv + tok0 * D3, D3, offs, A, a16, hd);
  const int offs_da[1] = {h0};
  stage_rows_bf16(das, da + tok0 * D, D, offs_da, A, a16, hd);
  int mine = 0;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    valid[j] = mask[tok0 + j] != 0;
    mine |= valid[j];
  }
  tc::cp_async_wait<0>();
  const int any_valid = __syncthreads_or(mine);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's queries, then keys
  const int nkt = a16 / 8, nct = hd / 8;
  float p[kKeyTiles][4] = {};
  float dp[kKeyTiles][4] = {};
  for (int k0 = 0; k0 < hd; k0 += 16) {
    unsigned a[4];
    load_a_frag(a, qs, ldh, m0, k0, false);
    mma_row_tile(p, a, ks, ldh, k0, nkt, false);   // S = q k^T
    load_a_frag(a, das, ldh, m0, k0, false);
    mma_row_tile(dp, a, vs, ldh, k0, nkt, false);  // dP = dattn v^T
  }
  // P (f32) for rows g and g + 8; 0 for padded queries and masked keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool row_ok = any_valid && m0 + g + 8 * h < A;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const bool ok = j < nkt && key < A && valid[key];
        p[j][2 * h + e] = ok ? p[j][2 * h + e] : -INFINITY;
        mx = fmaxf(mx, p[j][2 * h + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = p[j][2 * h + e];
        p[j][2 * h + e] = v == -INFINITY ? 0.f : expf(v - mx);
        sum += p[j][2 * h + e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float r = 0.f;  // rowsum(dP o P)
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][2 * h + e] = row_ok ? p[j][2 * h + e] / sum : 0.f;
        r += dp[j][2 * h + e] * p[j][2 * h + e];
      }
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)  // dS, rounded
        dp[j][2 * h + e] =
            __bfloat162float(__float2bfloat16(p[j][2 * h + e] * (dp[j][2 * h + e] - r)));
  }
  // P_c and dS to shared memory for the key side
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      if (j >= nkt) break;
      *reinterpret_cast<unsigned*>(pcs + m * ldp + j * 8 + 2 * t) =
          pack_bf16(p[j][2 * h], p[j][2 * h + 1]);
      *reinterpret_cast<unsigned*>(dss + m * ldp + j * 8 + 2 * t) =
          pack_bf16(dp[j][2 * h], dp[j][2 * h + 1]);
    }
  }
  // o = P_c v, then dq = dS k (x scale): the accumulators as A operands
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float o[kColTiles][4] = {};
#pragma unroll
    for (int kt = 0; kt < kKeyTiles / 2; ++kt) {
      if (2 * kt >= nkt) break;
      unsigned a[4];
      if (pass == 0)
        acc_to_a_frag(a, p, kt);
      else
        acc_to_a_frag(a, dp, kt);
      mma_row_tile(o, a, pass == 0 ? vs : ks, ldh, kt * 16, nct, true);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      if (m >= A) continue;
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        if (n >= nct) break;
        const int c = h0 + n * 8 + 2 * t;
        if (pass == 0) {
          *reinterpret_cast<__nv_bfloat162*>(attn + (tok0 + m) * D + c) =
              __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dqkv_c + (tok0 + m) * D3 + c) =
              __floats2bfloat162_rn(o[n][2 * h] * scale, o[n][2 * h + 1] * scale);
        }
      }
    }
    if (pass == 1)
      sum_rows(o, m0, A, hd, scale, warp_sums, row_sums + blockIdx.y * static_cast<size_t>(D3) + h0);
  }
  __syncthreads();
  // key side, this warp's 16 keys: dk = dS^T q (pass 0), dv = P_c^T dattn
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float acc[kColTiles][4] = {};
    for (int q0 = 0; q0 < a16; q0 += 16) {
      unsigned a[4];
      load_a_frag(a, pass == 0 ? dss : pcs, ldp, m0, q0, true);  // stored [query][key]
      mma_row_tile(acc, a, pass == 0 ? qs : das, ldh, q0, nct, true);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      if (m >= A) continue;
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        if (n >= nct) break;
        const size_t at = (tok0 + m) * D3 + (pass + 1) * D + h0 + n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dqkv_c + at) =
            __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    sum_rows(acc, m0, A, hd, 1.f, warp_sums,
             row_sums + blockIdx.y * static_cast<size_t>(D3) + (pass + 1) * D + h0);
  }
}

size_t resident_smem_bytes(int A, int hd) {
  return sizeof(float) * (4 * A * row_pitch(hd) + 2 * A * ((A + 3) & ~3));
}
size_t mma_smem_bytes(int A, int hd) {
  const int a16 = pad16(A);
  return sizeof(bf16) * (4 * a16 * (hd + 8) + 2 * a16 * (a16 + 8));
}
size_t tiled_smem_bytes(int hd) {
  return sizeof(float) * (6 * kTile * (col_chunk(hd) + 4) + 2 * kTile * kTile + 3 * kTile) +
         kTile;
}

template <typename T>
cudaError_t launch_attention_backward(const T* qkv, const T* da, const unsigned char* mask,
                                      float* dqkv, T* dqkv_c, T* attn, float* stats, int rows,
                                      int A, int D, int H, float scale, cudaStream_t stream) {
  const int hd = D / H;
  const dim3 grid(H, rows);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_attention(A, hd)) {
      static unsigned smem_set = 0;
      err = tc::allow_smem(reinterpret_cast<const void*>(attention_backward_mma_kernel),
                           static_cast<int>(mma_smem_bytes(kMmaMaxA, kMmaMaxHeadDim)), smem_set);
      if (err != cudaSuccess) return err;
      attention_backward_mma_kernel<<<grid, 32 * (pad16(A) / 16), mma_smem_bytes(A, hd),
                                      stream>>>(qkv, da, mask, dqkv, dqkv_c, attn, A, D, H,
                                                scale);  // dqkv holds the row sums
      return cudaGetLastError();
    }
  }
  if (resident_attention(A, hd)) {
    static unsigned smem_set = 0;
    err = tc::allow_smem(reinterpret_cast<const void*>(attention_backward_kernel<T>),
                         static_cast<int>(resident_smem_bytes(kResidentA, kResidentHeadDim)),
                         smem_set);
    if (err != cudaSuccess) return err;
    attention_backward_kernel<T><<<grid, kThreads, resident_smem_bytes(A, hd), stream>>>(
        qkv, da, mask, dqkv, dqkv_c, attn, A, D, H, scale);
  } else {
    static unsigned smem_set = 0;
    err = tc::allow_smem(reinterpret_cast<const void*>(attention_backward_tiled_kernel<T>),
                         static_cast<int>(tiled_smem_bytes(kColChunk)), smem_set);
    if (err != cudaSuccess) return err;
    attention_backward_tiled_kernel<T><<<grid, kThreadsTiled, tiled_smem_bytes(hd), stream>>>(
        qkv, da, mask, dqkv, dqkv_c, attn, stats, A, D, H, scale);
  }
  return cudaGetLastError();
}

// The bias gradients db_qkv = sum_t dqkv[t] and db_out = sum_t g[t] (f32,
// unrounded), in two launches and a fixed order: blocks of 32 columns x
// kSumRows threads; in the first, block (x, s) sums slice s of Y's T rows
// (thread row y takes rows y, y + kSumRows, ... of the slice; the rows'
// sums are then added in order of y) into partial[s][col]; in the second,
// one block row adds the kSlices partials in order of s. Columns
// [0, n0) are Y0's (T0 rows), [n0, n0 + n1) Y1's (T1 rows).
constexpr int kSumRows = 8;
constexpr int kSlices = 16;

__global__ void __launch_bounds__(32 * kSumRows)
column_sum_kernel(const float* __restrict__ Y0, int n0, int T0, const float* __restrict__ Y1,
                  int n1, int T1, float* __restrict__ out0, float* __restrict__ out1) {
  __shared__ float part[kSumRows][33];
  const int blocks0 = (n0 + 31) / 32;
  const bool first = blockIdx.x < blocks0;
  const int n = (first ? blockIdx.x : blockIdx.x - blocks0) * 32 + threadIdx.x;
  const int N = first ? n0 : n1, T = first ? T0 : T1;
  const float* Y = first ? Y0 : Y1;
  const int per = (T + gridDim.y - 1) / gridDim.y;
  const int t0 = blockIdx.y * per, t1 = min(T, t0 + per);
  float s = 0.f;
  if (n < N)
    for (int t = t0 + threadIdx.y; t < t1; t += kSumRows) s += Y[static_cast<size_t>(t) * N + n];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float total = 0.f;
    for (int y = 0; y < kSumRows; ++y) total += part[y][threadIdx.x];
    (first ? out0 : out1)[static_cast<size_t>(blockIdx.y) * N + n] = total;
  }
}

// sums_qkv: (t_qkv, 3D), the f32 dqkv per token or the row sums of the
// tensor-core attention backward; g: (tokens, D).
cudaError_t launch_bias_sums(const float* sums_qkv, int t_qkv, const float* g, int tokens,
                             float* partial, float* db_qkv, float* db_out, int D,
                             cudaStream_t stream) {
  const int blocks = (3 * D + 31) / 32 + (D + 31) / 32;
  float* part_qkv = partial;                    // kSlices x 3D
  float* part_out = partial + kSlices * 3 * D;  // kSlices x D
  column_sum_kernel<<<dim3(blocks, kSlices), dim3(32, kSumRows), 0, stream>>>(
      sums_qkv, 3 * D, t_qkv, g, D, tokens, part_qkv, part_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<dim3(blocks, 1), dim3(32, kSumRows), 0, stream>>>(
      part_qkv, 3 * D, kSlices, part_out, D, kSlices, db_qkv, db_out);
  return cudaGetLastError();
}

// Stages 2-7 in the compute type T: x, g, w_qkv, w_out are the product
// operands (bf16 copies or the f32 inputs).
template <typename T>
cudaError_t backward(const T* x, const unsigned char* mask, const T* g, const T* w_qkv,
                     const float* b_qkv, const T* w_out, int w_out_t, float* dx, float* dw_qkv,
                     float* dw_out, T* qkv, T* da, float* dqkv, T* dqkv_c, T* attn,
                     float* stats, int rows, int A, int D, int H, float scale, float scale_c,
                     cudaStream_t s) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  const int tokens = rows * A;
  const tc::Epilogue none{nullptr, 0, 1.f, 0};
  cudaError_t err = tc::gemm<T, T, false, false>(
      x, w_qkv, qkv, tokens, 3 * D, D, tc::Epilogue{b_qkv, D, scale_c, kBf16}, s);
  if (err != cudaSuccess) return err;
  // dattn = g . W_out^T: (out, in) storage is W_out^T row-major
  err = w_out_t ? tc::gemm<T, T, false, false>(g, w_out, da, tokens, D, D, none, s)
                : tc::gemm<T, T, false, true>(g, w_out, da, tokens, D, D, none, s);
  if (err != cudaSuccess) return err;
  err = launch_attention_backward<T>(qkv, da, mask, dqkv, dqkv_c, attn, stats, rows, A, D, H,
                                     scale, s);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, float, false, true>(dqkv_c, w_qkv, dx, tokens, D, 3 * D, none, s);
  if (err != cudaSuccess) return err;
  // dW_qkv = x^T . dqkv and dW_out (in, out) = attn^T . g in one launch
  return tc::gemm_pair_long_k<T, true, false>(
      tc::Problem<T, float>{x, dqkv_c, dw_qkv, D, 3 * D, tokens, none},
      tc::Problem<T, float>{attn, g, dw_out, D, D, tokens, none}, s);
}

}  // namespace

// x, g (rows, A, D) f32; mask (rows, A) bytes, nonzero = valid key;
// w_qkv (D, 3D) f32; b_qkv (3D) f32; w_out f32, (D_in, D_out) row-major or,
// when w_out_t != 0, its transpose (D_out, D_in) row-major. Outputs dx
// (rows, A, D), dw_qkv (D, 3D), db_qkv (3D), dw_out (D_in, D_out) and
// db_out (D), all f32. scale = float32(1 / sqrt(D / num_heads)); scale_c is
// scale rounded to the compute type. Scratch from the caller, each 16-byte
// aligned, in the compute type (bf16 or f32): qkv (rows*A*3D), da
// (rows*A*D), dqkv_c (rows*A*3D; unused in f32 mode, where dqkv serves),
// attn (rows*A*D); in bf16 mode also x_c, g_c (rows*A*D), w_qkv_c (D*3D),
// w_out_c (D*D); always dqkv (rows*A*3D: per token, or per row in the
// tensor-core case), partial (16*4D) and stats (rows*A*num_heads*3: the
// tiled attention's per-query softmax statistics) f32. Takes any A >= 1 and
// any D that num_heads divides. Returns the first cudaError_t of its
// launches (0 on success); nothing is launched for bad sizes.
extern "C" int fused_graph_attention_backward(
    const void* x, const void* mask, const void* g, const void* w_qkv, const void* b_qkv,
    const void* w_out, void* dx, void* dw_qkv, void* db_qkv, void* dw_out, void* db_out,
    void* x_c, void* g_c, void* w_qkv_c, void* w_out_c, void* qkv, void* da, void* dqkv,
    void* dqkv_c, void* attn, void* partial, void* stats, int rows, int A, int D, int num_heads,
    int use_bf16, int w_out_t, float scale, float scale_c, void* stream) {
  if (rows < 0 || A < 1 || num_heads < 1 || D < 1 || D % num_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* bq = static_cast<const float*>(b_qkv);
  auto* dxf = static_cast<float*>(dx);
  auto* dwq = static_cast<float*>(dw_qkv);
  auto* dwo = static_cast<float*>(dw_out);
  auto* dq = static_cast<float*>(dqkv);
  auto s = static_cast<cudaStream_t>(stream);
  const int tokens = rows * A;
  cudaError_t err = cudaSuccess;
  if (rows > 0 && use_bf16) {
    const long td = static_cast<long>(tokens) * D;
    tc::ConvertJob job{{static_cast<const float*>(x), static_cast<const float*>(g),
                        static_cast<const float*>(w_qkv), static_cast<const float*>(w_out)},
                       {static_cast<bf16*>(x_c), static_cast<bf16*>(g_c),
                        static_cast<bf16*>(w_qkv_c), static_cast<bf16*>(w_out_c)},
                       {td, td, 3L * D * D, static_cast<long>(D) * D}};
    err = tc::convert(job, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = backward<bf16>(static_cast<const bf16*>(x_c), m, static_cast<const bf16*>(g_c),
                         static_cast<const bf16*>(w_qkv_c), bq,
                         static_cast<const bf16*>(w_out_c), w_out_t, dxf, dwq, dwo,
                         static_cast<bf16*>(qkv), static_cast<bf16*>(da), dq,
                         static_cast<bf16*>(dqkv_c), static_cast<bf16*>(attn),
                         static_cast<float*>(stats), rows, A, D, num_heads, scale, scale_c, s);
  } else if (rows > 0) {
    err = backward<float>(static_cast<const float*>(x), m, static_cast<const float*>(g),
                          static_cast<const float*>(w_qkv), bq,
                          static_cast<const float*>(w_out), w_out_t, dxf, dwq, dwo,
                          static_cast<float*>(qkv), static_cast<float*>(da), dq, dq,
                          static_cast<float*>(attn), static_cast<float*>(stats), rows, A, D,
                          num_heads, scale, scale_c, s);
  } else {  // no token: the weight gradients are 0
    err = cudaMemsetAsync(dwq, 0, sizeof(float) * 3L * D * D, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dwo, 0, sizeof(float) * D * D, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tensor-core attention backward leaves per-row sums in dqkv
  const bool row_sums = use_bf16 && mma_attention(A, D / num_heads);
  err = launch_bias_sums(dq, row_sums ? rows : tokens, static_cast<const float*>(g), tokens,
                         static_cast<float*>(partial), static_cast<float*>(db_qkv),
                         static_cast<float*>(db_out), D, s);
  return static_cast<int>(err);
}
