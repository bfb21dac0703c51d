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
// queries; otherwise on CUDA cores from f32 rows: A <= 64 with head dim <=
// 128 in one pass over resident rows (the shared warp softmax of
// softmax64.cuh), any other shape by the tiled kernel, per 64 queries over
// chunks of 64 keys and, past head dim 128, chunks of 128 columns
// (attention_rows.cuh), a first pass for the running max and sum and a
// second for the rounded P and P.v. Device launches per call: bf16 4 (one
// f32 -> bf16 conversion of x and the weights, QKV product, attention,
// output product), f32 3. No sum depends on the launch order or uses
// atomics: two runs give the same bits.
//
// Shapes: any A >= 1, any head dim, any D that the head count divides.
// Operand rows that are not a multiple of 16 bytes (D % 8 != 0 in bf16,
// D % 4 != 0 in f32) take the product's element loads (tc_gemm.cuh). No
// buffer here grows with A or the head dim: the card's memory for the
// caller's tensors is the only limit.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_rows.cuh"
#include "softmax64.cuh"
#include "tc_gemm.cuh"

namespace {

using tc::bf16;

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // queries per block and keys per pass

// The resident kernel: A <= 64, head dim <= 128.
size_t attention_smem_bytes(int A, int hd) {
  const int a4 = (A + 3) & ~3;
  return sizeof(float) * (4 * A * row_pitch(hd) + A * a4) + kResidentA;
}

// qkv (T, 3D) of type T: q (already scaled), k, v; attn (T, D) of type T.
// Block (head, row), A <= 64 and head dim <= 128: the row-head's q, k and v
// rows stay in shared memory. Each thread computes logits one at a time
// (float4 reads along the head dim) and P.v four columns at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_forward_kernel(const T* __restrict__ qkv, const unsigned char* __restrict__ mask,
                         T* __restrict__ attn, int A, int D, int H) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, hd4 = padded_head_dim(hd), ld = row_pitch(hd), D3 = 3 * D;
  const int h0 = blockIdx.x * hd;
  const int pld = (A + 3) & ~3;  // P's pitch
  float* qs = smem;          // A x ld each: q, k, v
  float* ks = qs + A * ld;
  float* vs = ks + A * ld;
  float* os = vs + A * ld;   // A x ld: P.v
  float* ps = os + A * ld;   // A x pld: logits, then P
  unsigned char* valid = reinterpret_cast<unsigned char*>(ps + A * pld);

  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * A;
  const T* base = qkv + tok0 * D3 + h0;

  int mine = 0;
  for (int j = tid; j < A; j += kThreads) {
    valid[j] = mask[tok0 + j] != 0;
    mine |= valid[j];
  }
  load_rows(qs, ld, base, D3, A, hd, kThreads);
  load_rows(ks, ld, base + D, D3, A, hd, kThreads);
  load_rows(vs, ld, base + 2 * D, D3, A, hd, kThreads);
  const int any_valid = __syncthreads_or(mine);
  for (int idx = tid; idx < A * A; idx += kThreads) {
    const int i = idx / A, j = idx - i * A;
    ps[i * pld + j] = dot_rows(qs + i * ld, ks + j * ld, hd4);
  }
  __syncthreads();
  for (int i = warp; i < A; i += kThreads / 32)
    warp_masked_softmax64(ps + i * pld, valid, A, any_valid, kBf16);
  __syncthreads();
  const int n4 = hd4 / 4;
  for (int idx = tid; idx < A * n4; idx += kThreads) {
    const int i = idx / n4, c = (idx - i * n4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < A; ++j) axpy4(o, ps[i * pld + j], vs + j * ld + c);
    store4(attn + (tok0 + i) * D + h0 + c, c, hd, o);
  }
}

// The tiled kernel: any A, any head dim. Block (query chunk, head, row);
// per pass chunks of kChunk keys, and columns in chunks of col_chunk(hd).
size_t tiled_smem_bytes(int hd) {
  return sizeof(float) * (4 * kChunk * (col_chunk(hd) + 4) + kChunk * kChunk + 2 * kChunk) +
         kChunk;
}

// Pass 1 takes each query's running max and sum over the key chunks; pass
// 2, for each output column chunk, recomputes the logits chunk by chunk,
// rounds P = exp(s - max) / sum (bf16 mode) as the plain version does, and
// adds P.v over the key chunks. Two passes rather than an online softmax,
// so that P is rounded after its normalisation, where the plain version
// rounds it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_forward_tiled_kernel(const T* __restrict__ qkv, const unsigned char* __restrict__ mask,
                               T* __restrict__ attn, int A, int D, int H) {
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, D3 = 3 * D;
  const int cwmax = col_chunk(hd), ld = cwmax + 4;
  const int ncc = (hd + cwmax - 1) / cwmax;
  const int h0 = blockIdx.y * hd;
  const int q0 = blockIdx.x * kChunk;
  const int nq = min(kChunk, A - q0);
  const int nkb = (A + kChunk - 1) / kChunk;
  float* qs = smem;              // kChunk x ld each: a column chunk of q, k, v
  float* ks = qs + kChunk * ld;
  float* vs = ks + kChunk * ld;
  float* os = vs + kChunk * ld;  // kChunk x ld: P.v of one output column chunk
  float* ps = os + kChunk * ld;  // kChunk x kChunk: logits, then P
  float* m_run = ps + kChunk * kChunk;
  float* l_run = m_run + kChunk;
  unsigned char* kvalid = reinterpret_cast<unsigned char*>(l_run + kChunk);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(blockIdx.z) * A;
  const T* base = qkv + tok0 * D3 + h0;

  int mine = 0;
  for (int j = tid; j < A; j += kThreads) mine |= mask[tok0 + j] != 0;
  for (int i = tid; i < nq; i += kThreads) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int any_valid = __syncthreads_or(mine);

  // ps = q k^T for keys [k0, k0 + nk), summed over the column chunks;
  // leaves the last column chunk of q and k staged and kvalid filled
  // (q is staged once when the head dim is one column chunk)
  const bool q_resident = ncc == 1;
  if (q_resident) load_rows(qs, ld, base + static_cast<size_t>(q0) * D3, D3, nq, hd, kThreads);
  auto logits = [&](int k0, int nk) {
    for (int cc = 0; cc < ncc; ++cc) {
      const int c0 = cc * cwmax, cw = min(cwmax, hd - c0), cw4 = padded_head_dim(cw);
      __syncthreads();  // the previous readers of qs, ks and ps are done
      if (!q_resident)
        load_rows(qs, ld, base + static_cast<size_t>(q0) * D3 + c0, D3, nq, cw, kThreads);
      load_rows(ks, ld, base + static_cast<size_t>(k0) * D3 + D + c0, D3, nk, cw, kThreads);
      if (cc == 0)
        for (int j = tid; j < nk; j += kThreads) kvalid[j] = mask[tok0 + k0 + j] != 0;
      __syncthreads();
      for (int idx = tid; idx < nq * nk; idx += kThreads) {
        const int i = idx / nk, j = idx - i * nk;
        const float s = dot_rows(qs + i * ld, ks + j * ld, cw4);
        ps[i * kChunk + j] = cc == 0 ? s : ps[i * kChunk + j] + s;
      }
    }
    __syncthreads();
  };

  // pass 1: each query's running max and sum over the valid keys
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kChunk, nk = min(kChunk, A - k0);
    logits(k0, nk);
    for (int i = warp; i < nq; i += kThreads / 32) {
      float s[2];
      float mc = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        s[t] = (j < nk && kvalid[j]) ? ps[i * kChunk + j] : -INFINITY;
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
  // pass 2: per output column chunk, the rounded softmax weights and P . v
  for (int oc = 0; oc < ncc; ++oc) {
    const int c0 = oc * cwmax, cw = min(cwmax, hd - c0), n4 = padded_head_dim(cw) / 4;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * kChunk, nk = min(kChunk, A - k0);
      logits(k0, nk);
      load_rows(vs, ld, base + static_cast<size_t>(k0) * D3 + 2 * D + c0, D3, nk, cw, kThreads);
      for (int idx = tid; idx < nq * nk; idx += kThreads) {
        const int i = idx / nk, j = idx - i * nk;
        ps[i * kChunk + j] =
            (any_valid && kvalid[j])
                ? round_to(expf(ps[i * kChunk + j] - m_run[i]) / l_run[i], kBf16)
                : 0.f;
      }
      __syncthreads();
      // os (+)= P . v over this chunk's keys; each thread keeps its elements
      for (int idx = tid; idx < nq * n4; idx += kThreads) {
        const int i = idx / n4, c = (idx - i * n4) * 4;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < nk; ++j) axpy4(o, ps[i * kChunk + j], vs + j * ld + c);
        float4* dst = reinterpret_cast<float4*>(os + i * ld + c);
        if (kb > 0) {
          const float4 prev = *dst;
          o = make_float4(prev.x + o.x, prev.y + o.y, prev.z + o.z, prev.w + o.w);
        }
        *dst = o;
      }
    }
    // each thread writes the elements it accumulated
    for (int idx = tid; idx < nq * n4; idx += kThreads) {
      const int i = idx / n4, c = (idx - i * n4) * 4;
      store4(attn + (tok0 + q0 + i) * D + h0 + c0 + c, c, cw,
             *reinterpret_cast<const float4*>(os + i * ld + c));
    }
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

  if (resident_attention(A, hd)) {
    static unsigned smem_set = 0;
    cudaError_t err = tc::allow_smem(
        reinterpret_cast<const void*>(attention_forward_kernel<T>),
        static_cast<int>(attention_smem_bytes(kResidentA, kResidentHeadDim)), smem_set);
    if (err != cudaSuccess) return err;
    attention_forward_kernel<T><<<dim3(H, rows), kThreads, attention_smem_bytes(A, hd), stream>>>(
        qkv, mask, attn, A, D, H);
    return cudaGetLastError();
  }
  static unsigned smem_set = 0;
  cudaError_t err = tc::allow_smem(
      reinterpret_cast<const void*>(attention_forward_tiled_kernel<T>),
      static_cast<int>(tiled_smem_bytes(kColChunk)), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((A + kChunk - 1) / kChunk, H, rows);
  attention_forward_tiled_kernel<T><<<grid, kThreads, tiled_smem_bytes(hd), stream>>>(
      qkv, mask, attn, A, D, H);
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
// Takes any A >= 1 and any D that num_heads divides.
// Returns the first cudaError_t of its launches (0 on success); nothing is
// launched for bad sizes.
extern "C" int fused_graph_attention_forward(
    const void* x, const void* mask, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, void* out, void* x_c, void* w_qkv_c,
    void* w_out_c, void* qkv, void* attn, int rows, int A, int D, int num_heads,
    int use_bf16, int w_out_t, float scale, void* stream) {
  if (rows < 0 || A < 1 || num_heads < 1 || D < 1 || D % num_heads != 0)
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
