// Fused graph attention forward (K1) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fused_kernel` of
// crowdnav_prediction_attngraph_tpu/ops/masked_attention.py (launched by
// `_fused_forward`): for every row (one env's human-human graph of A agents)
//
//   qkv = x . W_qkv + b_qkv                      (A, 3D), f32 accumulation
//   o_h = softmax(q_h k_h^T / sqrt(hd) + mask) v_h   for each of H heads
//   out = concat_h(o_h) . W_out + b_out          (A, D)
//
// restricted to the row's own A tokens; keys whose mask byte is 0 get no
// weight. A row with no valid key has an all-zero attention output, so its
// result is exactly b_out (the TPU kernel leaked its strip's mean there).
//
// In bf16 mode x, the weights, q/k/v, the softmax weights P and the attention
// output are rounded to bf16 at the points where `_fused_kernel` casts to its
// compute dtype; every product accumulates in f32 and the biases stay f32.
//
// What bounds it: the two projections are 8 T D^2 FLOP over T = rows x A
// tokens (40 GFLOP at 960 x 20, D = 512) against 4 rows A^2 D of attention
// (QK^T and PV, 2% of it at A = 20), so the card's tensor-core rate bounds
// it at large rows; at the evaluation's and rollout's rows (640 and 1280
// tokens) it is a few microseconds of work and the launches bound it.
//
// Design: the projections are two launches of one tiled tensor-core product
// (tc_gemm.cuh: cp.async ring, ldmatrix, mma.sync bf16 with f32
// accumulation; the f32 mode runs the same tiles on CUDA-core FMAs) over all
// T tokens at once, so each weight tile is read from L2 once per 128 tokens
// instead of once per row; the QKV product's epilogue adds the bias, scales
// q and rounds. Between them runs the masked softmax attention, one block per
// (row, head): in bf16 with A <= 64 and head dim % 16 == 0 (the paths'
// shapes) on mma.sync from bf16 rows in shared memory, one warp per 16
// queries; otherwise on CUDA cores from f32 rows, per 64 queries, A <= 64 in
// one pass (the shared warp softmax of softmax64.cuh), larger A over chunks
// of 64 keys, a first pass for the running max and sum and a second for the
// rounded P and P.v. Device launches per call: bf16 4 (one f32 -> bf16
// conversion of x and the weights, QKV product, attention, output product),
// f32 3. No sum depends on the launch order or uses atomics: two runs give
// the same bits.
//
// Limits: 1 <= A <= 256, head dim <= 128, D % 8 == 0 (16-byte copies).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_rows.cuh"
#include "softmax64.cuh"
#include "tc_gemm.cuh"

namespace {

using tc::bf16;

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // queries per block and keys per pass
constexpr int kMaxA = 256;
constexpr int kMaxHeadDim = 128;

size_t attention_smem_bytes(int A, int hd) {
  const int kc = A < kChunk ? A : kChunk;
  const int kc4 = (kc + 3) & ~3;
  return sizeof(float) * (4 * kc * row_pitch(hd) + kc * kc4 + 2 * kChunk) + kMaxA;
}

// qkv (T, 3D) of type T: q (already scaled), k, v; attn (T, D) of type T.
// Block (query chunk, head, row). Each thread computes logits one at a time
// (float4 reads along the head dim) and P.v four columns at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_forward_kernel(const T* __restrict__ qkv, const unsigned char* __restrict__ mask,
                         T* __restrict__ attn, int A, int D, int H) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, hd4 = padded_head_dim(hd), ld = row_pitch(hd), D3 = 3 * D;
  const int h0 = blockIdx.y * hd;
  const int q0 = blockIdx.x * kChunk;
  const int nq = min(kChunk, A - q0);
  const int kc = min(kChunk, A);  // keys per pass
  const int pld = (kc + 3) & ~3;  // P's pitch
  const int nkb = (A + kChunk - 1) / kChunk;
  float* qs = smem;          // nq x ld
  float* ks = qs + kc * ld;  // kc x ld
  float* vs = ks + kc * ld;
  float* os = vs + kc * ld;  // nq x ld: P.v summed over key chunks
  float* ps = os + kc * ld;  // nq x pld: logits, then P
  float* m_run = ps + kc * pld;
  float* l_run = m_run + kChunk;
  unsigned char* valid = reinterpret_cast<unsigned char*>(l_run + kChunk);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(blockIdx.z) * A;
  const T* base = qkv + tok0 * D3 + h0;

  int mine = 0;
  for (int j = tid; j < A; j += kThreads) {
    valid[j] = mask[tok0 + j] != 0;
    mine |= valid[j];
  }
  load_rows(qs, ld, base + static_cast<size_t>(q0) * D3, D3, nq, hd, kThreads);
  const int any_valid = __syncthreads_or(mine);

  auto load_kv = [&](int k0, int nk, bool with_v) {
    load_rows(ks, ld, base + static_cast<size_t>(k0) * D3 + D, D3, nk, hd, kThreads);
    if (with_v) load_rows(vs, ld, base + static_cast<size_t>(k0) * D3 + 2 * D, D3, nk, hd, kThreads);
  };
  auto logits = [&](int nk) {
    for (int idx = tid; idx < nq * nk; idx += kThreads) {
      const int i = idx / nk, j = idx - i * nk;
      ps[i * pld + j] = dot_rows(qs + i * ld, ks + j * ld, hd4);
    }
  };
  // os (+)= P . v over this chunk's nk keys; each thread keeps its elements
  auto accumulate_pv = [&](int nk, bool first) {
    const int n4 = hd4 / 4;
    for (int idx = tid; idx < nq * n4; idx += kThreads) {
      const int i = idx / n4, c = (idx - i * n4) * 4;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < nk; ++j) axpy4(o, ps[i * pld + j], vs + j * ld + c);
      float4* dst = reinterpret_cast<float4*>(os + i * ld + c);
      if (!first) {
        const float4 prev = *dst;
        o = make_float4(prev.x + o.x, prev.y + o.y, prev.z + o.z, prev.w + o.w);
      }
      *dst = o;
    }
  };

  if (nkb == 1) {
    load_kv(0, A, true);
    __syncthreads();
    logits(A);
    __syncthreads();
    for (int i = warp; i < nq; i += kThreads / 32)
      warp_masked_softmax64(ps + i * pld, valid, A, any_valid, kBf16);
    __syncthreads();
    accumulate_pv(A, true);
  } else {
    // pass 1: each query's running max and sum over the valid keys
    for (int i = tid; i < nq; i += kThreads) {
      m_run[i] = -INFINITY;
      l_run[i] = 0.f;
    }
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * kChunk, nk = min(kChunk, A - k0);
      __syncthreads();
      load_kv(k0, nk, false);
      __syncthreads();
      logits(nk);
      __syncthreads();
      for (int i = warp; i < nq; i += kThreads / 32) {
        float s[2];
        float mc = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = lane + 32 * t;
          s[t] = (j < nk && valid[k0 + j]) ? ps[i * pld + j] : -INFINITY;
          mc = fmaxf(mc, s[t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
        const float m_old = m_run[i];
        const float m_new = fmaxf(m_old, mc);
        if (m_new == -INFINITY) continue;  // no valid key yet (the whole warp)
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) sum += s[t] == -INFINITY ? 0.f : expf(s[t] - m_new);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          l_run[i] = l_run[i] * expf(m_old - m_new) + sum;
          m_run[i] = m_new;
        }
      }
    }
    // pass 2: the rounded softmax weights and P . v, chunk by chunk
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * kChunk, nk = min(kChunk, A - k0);
      __syncthreads();
      load_kv(k0, nk, true);
      __syncthreads();
      logits(nk);
      __syncthreads();
      for (int idx = tid; idx < nq * nk; idx += kThreads) {
        const int i = idx / nk, j = idx - i * nk;
        ps[i * pld + j] = (any_valid && valid[k0 + j])
                              ? round_to(expf(ps[i * pld + j] - m_run[i]) / l_run[i], kBf16)
                              : 0.f;
      }
      __syncthreads();
      accumulate_pv(nk, kb == 0);
    }
  }
  // each thread writes the elements it accumulated
  const int n4 = hd4 / 4;
  for (int idx = tid; idx < nq * n4; idx += kThreads) {
    const int i = idx / n4, c = (idx - i * n4) * 4;
    store4(attn + (tok0 + q0 + i) * D + h0 + c, c, hd,
           *reinterpret_cast<const float4*>(os + i * ld + c));
  }
}

// The tensor-core variant for bf16, A <= 64, head dim % 16 == 0 (the
// paths' shapes): one block per (head, row), one warp per 16 queries. S =
// q k^T and P . v run on mma.sync from the staged bf16 rows; the masked
// softmax runs on S's accumulators (each row's values sit in one quad of
// lanes), and the rounded P is the A operand of P . v straight from them.
__global__ void __launch_bounds__(32 * kMmaMaxA / 16)
attention_forward_mma_kernel(const bf16* __restrict__ qkv, const unsigned char* __restrict__ mask,
                             bf16* __restrict__ attn, int A, int D, int H) {
  constexpr int kKeyTiles = kMmaMaxA / 8, kColTiles = kMmaMaxHeadDim / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned char valid[kMmaMaxA];
  const int hd = D / H, ldh = hd + 8, a16 = pad16(A);
  const int h0 = blockIdx.x * hd;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * A;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // a16 x ldh each: q, k, v
  bf16* ks = qs + a16 * ldh;
  bf16* vs = ks + a16 * ldh;
  const int offs[3] = {h0, D + h0, 2 * D + h0};
  stage_rows_bf16(qs, qkv + tok0 * 3 * D, 3 * D, offs, A, a16, hd);
  int mine = 0;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    valid[j] = mask[tok0 + j] != 0;
    mine |= valid[j];
  }
  tc::cp_async_wait<0>();
  const int any_valid = __syncthreads_or(mine);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's queries
  const int nkt = a16 / 8, nct = hd / 8;
  float s[kKeyTiles][4] = {};
  for (int k0 = 0; k0 < hd; k0 += 16) {
    unsigned a[4];
    load_a_frag(a, qs, ldh, m0, k0, false);
    mma_row_tile(s, a, ks, ldh, k0, nkt, false);  // k stored [key][c]
  }
  // masked softmax of rows g and g + 8 over the valid keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const bool ok = j < nkt && key < A && valid[key];
        s[j][2 * h + e] = ok ? s[j][2 * h + e] : -INFINITY;
        mx = fmaxf(mx, s[j][2 * h + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = s[j][2 * h + e];
        s[j][2 * h + e] = v == -INFINITY ? 0.f : expf(v - mx);
        sum += s[j][2 * h + e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[j][2 * h + e] = any_valid ? s[j][2 * h + e] / sum : 0.f;
  }
  // o = P_c v, P rounded to bf16 as it becomes the A operand
  float o[kColTiles][4] = {};
#pragma unroll
  for (int kt = 0; kt < kKeyTiles / 2; ++kt) {
    if (2 * kt >= nkt) break;
    unsigned a[4];
    acc_to_a_frag(a, s, kt);
    mma_row_tile(o, a, vs, ldh, kt * 16, nct, true);  // v stored [key][c]
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= A) continue;
#pragma unroll
    for (int n = 0; n < kColTiles; ++n) {
      if (n >= nct) break;
      *reinterpret_cast<__nv_bfloat162*>(attn + (tok0 + m) * D + h0 + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
}

template <typename T>
cudaError_t launch_attention(const T* qkv, const unsigned char* mask, T* attn, int rows, int A,
                             int D, int H, cudaStream_t stream) {
  const int hd = D / H;
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_attention(A, hd)) {
      static unsigned smem_set = 0;
      const int most = 3 * kMmaMaxA * (kMmaMaxHeadDim + 8) * sizeof(bf16);
      cudaError_t err = tc::allow_smem(
          reinterpret_cast<const void*>(attention_forward_mma_kernel), most, smem_set);
      if (err != cudaSuccess) return err;
      const size_t smem = 3 * pad16(A) * (hd + 8) * sizeof(bf16);
      attention_forward_mma_kernel<<<dim3(H, rows), 32 * (pad16(A) / 16), smem, stream>>>(
          qkv, mask, attn, A, D, H);
      return cudaGetLastError();
    }
  }

  static unsigned smem_set = 0;
  cudaError_t err =
      tc::allow_smem(reinterpret_cast<const void*>(attention_forward_kernel<T>),
                     static_cast<int>(attention_smem_bytes(kMaxA, kMaxHeadDim)), smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = attention_smem_bytes(A, D / H);
  const dim3 grid((A + kChunk - 1) / kChunk, H, rows);
  attention_forward_kernel<T><<<grid, kThreads, smem, stream>>>(qkv, mask, attn, A, D, H);
  return cudaGetLastError();
}

// x, w_qkv, w_out: the product operands in T (bf16 copies or the f32 inputs).
template <typename T>
cudaError_t forward(const T* x, const unsigned char* mask, const T* w_qkv, const float* b_qkv,
                    const T* w_out, int w_out_t, const float* b_out, float* out, T* qkv,
                    T* attn, int rows, int A, int D, int H, float scale, cudaStream_t s) {
  const int tokens = rows * A;
  cudaError_t err = tc::gemm<T, T, false, false>(x, w_qkv, qkv, tokens, 3 * D, D,
                                                 tc::Epilogue{b_qkv, D, scale, 0}, s);
  if (err != cudaSuccess) return err;
  err = launch_attention<T>(qkv, mask, attn, rows, A, D, H, s);
  if (err != cudaSuccess) return err;
  const tc::Epilogue bias{b_out, 0, 1.f, 0};
  if (w_out_t)  // w_out points at (out, in) storage: attn . (stored)^T
    return tc::gemm<T, float, false, true>(attn, w_out, out, tokens, D, D, bias, s);
  return tc::gemm<T, float, false, false>(attn, w_out, out, tokens, D, D, bias, s);
}

}  // namespace

// x (rows, A, D) f32; mask (rows, A) bytes, nonzero = valid key;
// w_qkv (D, 3D) f32; b_qkv (3D) f32; w_out f32, (D_in, D_out) row-major or,
// when w_out_t != 0, its transpose (D_out, D_in) row-major; b_out (D) f32;
// out (rows, A, D) f32. scale = float32(1 / sqrt(D / num_heads)).
// Scratch from the caller, each 16-byte aligned: in bf16 mode x_c (rows*A*D),
// w_qkv_c (D*3D), w_out_c (D*D), qkv (rows*A*3D) and attn (rows*A*D), all
// bf16; in f32 mode x_c, w_qkv_c and w_out_c are unused and qkv and attn
// are f32. use_bf16 != 0 selects bf16 rounding of the product inputs.
// Takes 1 <= A <= 256, D / num_heads <= 128 and D % 8 == 0.
// Returns the first cudaError_t of its launches (0 on success); nothing is
// launched for bad sizes.
extern "C" int fused_graph_attention_forward(
    const void* x, const void* mask, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, void* out, void* x_c, void* w_qkv_c,
    void* w_out_c, void* qkv, void* attn, int rows, int A, int D, int num_heads,
    int use_bf16, int w_out_t, float scale, void* stream) {
  if (rows < 0 || A < 1 || A > kMaxA || num_heads < 1 || D < 8 || D % num_heads != 0 ||
      D / num_heads > kMaxHeadDim || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* bq = static_cast<const float*>(b_qkv);
  const auto* bo = static_cast<const float*>(b_out);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_bf16) {
    const long tokens = static_cast<long>(rows) * A;
    tc::ConvertJob job{{static_cast<const float*>(x), static_cast<const float*>(w_qkv),
                        static_cast<const float*>(w_out), nullptr},
                       {static_cast<bf16*>(x_c), static_cast<bf16*>(w_qkv_c),
                        static_cast<bf16*>(w_out_c), nullptr},
                       {tokens * D, 3L * D * D, static_cast<long>(D) * D, 0}};
    err = tc::convert(job, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = forward<bf16>(static_cast<const bf16*>(x_c), m, static_cast<const bf16*>(w_qkv_c), bq,
                        static_cast<const bf16*>(w_out_c), w_out_t, bo, o,
                        static_cast<bf16*>(qkv), static_cast<bf16*>(attn), rows, A, D,
                        num_heads, scale, s);
  } else {
    err = forward<float>(static_cast<const float*>(x), m, static_cast<const float*>(w_qkv), bq,
                         static_cast<const float*>(w_out), w_out_t, bo, o,
                         static_cast<float*>(qkv), static_cast<float*>(attn), rows, A, D,
                         num_heads, scale, s);
  }
  return static_cast<int>(err);
}
