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
// a zero attention output, so its dq, dk, dv and dx are 0.
//
// Two passes, because blocks on the card run in parallel and in no order
// (the TPU's sequential grid accumulated the weight gradients across grid
// steps for free):
//
//  A. one block of 256 threads per row (one env-timestep's A <= 64 agents,
//     row_backward_kernel): dattn = g . W_out^T for all heads, then per head
//     the q/k/v recompute, the masked softmax (one warp per query), the
//     attention output, dv = P^T da, dS = P o (dP - rowsum(dP o P)),
//     dq = dS k scale and dk = dS^T q, and at the end dx = dqkv . W_qkv^T.
//     It writes dx, and dqkv (f32) and the rounded attention output to
//     scratch the wrapper allocates.
//  B. the weight gradients dW_qkv = X^T dQKV and dW_out = Attn^T G as
//     shared-memory-tiled products over all rows x A tokens, one block per
//     64 x 64 output tile looping over every token in a fixed order, and the
//     bias gradients as column sums reduced in a fixed order. No float
//     atomics: two runs on the same inputs give the same bits.
//
// What bounds it: at the update's shape (rows = 960, A = 20, D = 512) the
// work is ~22 T D^2 FLOP (T = rows x A tokens: the q/k/v recompute, dattn,
// dx, and the two weight products), so it is compute-bound. This first
// version runs every product on CUDA-core FMAs; pass A reads the weights
// through L2 once per row (the wrapper passes W_qkv^T and W_out^T so those
// reads are along contiguous rows). Tensor cores (wgmma), weight tiles in
// shared memory and several rows per block are left to a later version.

#include <cuda_runtime.h>
#include <math.h>

#include "softmax64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kMaxCols = 2;  // columns per thread in pass A: D <= 512
constexpr int kChunk = 64;   // features staged at a time in pass A

// Y (A x N) = round(X) . round(W) for X (A x K, row stride ldx) and W
// (K x N), both row-major in device memory; Y rounded if round_out. Thread t
// owns columns t and t + kThreads for 32 tokens at a time; X is staged in
// `chunk` (32 x kChunk), kChunk of its columns at a time. X may have
// been written by this block: it is read with plain loads after a barrier.
__device__ void token_block_product(const float* X, int ldx, int K,
                                    const float* __restrict__ W, float* Y,
                                    int A, int N, float* chunk, int bf16,
                                    bool round_out) {
  const int tid = threadIdx.x;
  for (int t0 = 0; t0 < A; t0 += 32) {
    const int nt = min(32, A - t0);
    float acc[kMaxCols][32];
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc)
#pragma unroll
      for (int a = 0; a < 32; ++a) acc[cc][a] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      __syncthreads();  // the previous chunk is read; X is complete
      for (int i = tid; i < nt * kc; i += kThreads) {
        const int a = i / kc;
        const int kk = i - a * kc;
        chunk[a * kChunk + kk] =
            round_to(X[static_cast<size_t>(t0 + a) * ldx + k0 + kk], bf16);
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc) {
        const int n = tid + cc * kThreads;
        if (n < N) {
          for (int kk = 0; kk < kc; ++kk) {
            const float w = round_to(__ldg(W + static_cast<size_t>(k0 + kk) * N + n), bf16);
#pragma unroll
            for (int a = 0; a < 32; ++a)
              if (a < nt) acc[cc][a] = fmaf(chunk[a * kChunk + kk], w, acc[cc][a]);
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int n = tid + cc * kThreads;
      if (n < N) {
#pragma unroll
        for (int a = 0; a < 32; ++a)
          if (a < nt)
            Y[static_cast<size_t>(t0 + a) * N + n] =
                round_out ? round_to(acc[cc][a], bf16) : acc[cc][a];
      }
    }
  }
}

// Pass A: one block of 256 threads per row (one env-timestep's A <= MAXA
// agents). Staging the row's x and g in f32 would take 2 x 64 x 512 x 4 B =
// 256 KiB at A = 64, more than the 227 KiB a block may use, so the block
// keeps only the current head resident (q, k, v, its dattn columns, P, dS
// and a staging chunk: 113 KiB at MAXA = 64, 49 KiB at MAXA = 32) and
//  * computes dattn = g_c . W_out^T_c for all heads first, 32 tokens at a
//    time, and parks it (rounded) in the row's dx, which is written last;
//  * re-reads x from L2 for each head's q/k/v recompute, kChunk features at
//    a time;
//  * writes dq, dk and dv only to the dqkv scratch, and at the end computes
//    dx = dqkv_c . W_qkv^T from there, 32 tokens at a time.
// Every sum runs in a fixed order, without atomics. MAXA is the tier of
// token slots that the unrolled loops run over (32 for A <= 32, else 64).
template <int MAXA>
__global__ void __launch_bounds__(kThreads)
row_backward_kernel(const float* __restrict__ x,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ g,
                    const float* __restrict__ w_qkv,
                    const float* __restrict__ w_qkv_t,
                    const float* __restrict__ b_qkv,
                    const float* __restrict__ w_out_t,
                    float* __restrict__ dx, float* __restrict__ dqkv,
                    float* __restrict__ attn, int A, int D, int H, int bf16) {
  extern __shared__ float smem[];
  const int hd = D / H;
  const int ld = hd + 1;  // padded stride: rows fall in distinct banks
  const int D3 = 3 * D;
  float* chunk = smem;                // MAXA x kChunk: x, g or dqkv columns
  float* qs = chunk + MAXA * kChunk;  // A x ld: q x scale (rounded)
  float* ks = qs + MAXA * ld;         // A x ld: k (rounded)
  float* vs = ks + MAXA * ld;         // A x ld: v (rounded)
  float* das = vs + MAXA * ld;        // A x ld: this head's dattn (rounded)
  float* ps = das + MAXA * ld;        // MAXA x MAXA: P (f32)
  float* dss = ps + MAXA * MAXA;      // MAXA x MAXA: dS (rounded)
  __shared__ unsigned char valid[MAXA];
  __shared__ int any_valid;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const float scale_c = round_to(scale, bf16);
  const size_t tok0 = static_cast<size_t>(row) * A;  // first token of the row
  float* dattn = dx + tok0 * D;  // parked in the row's dx until the end

  if (tid < MAXA) valid[tid] = (tid < A) ? (mask[tok0 + tid] != 0) : 0;
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int j = 0; j < A; ++j) any |= valid[j];
    any_valid = any;
  }

  token_block_product(g + tok0 * D, D, D, w_out_t, dattn, A, D, chunk, bf16, true);

  for (int h = 0; h < H; ++h) {
    const int h0 = h * hd;
    __syncthreads();  // dattn is complete; the last head's buffers are read
    for (int i = tid; i < A * hd; i += kThreads) {
      const int a = i / hd;
      const int c = i - a * hd;
      das[a * ld + c] = dattn[static_cast<size_t>(a) * D + h0 + c];
    }
    // recompute q_h x scale, k_h, v_h: thread t < 3*hd owns one column
    const int part = tid / hd;
    const int c = tid - part * hd;
    const int col = part * D + h0 + c;
    float p[MAXA];
#pragma unroll
    for (int a = 0; a < MAXA; ++a) p[a] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      const int kc = min(kChunk, D - d0);
      __syncthreads();
      for (int i = tid; i < A * kc; i += kThreads) {
        const int a = i / kc;
        const int kk = i - a * kc;
        chunk[a * kChunk + kk] = round_to(x[(tok0 + a) * D + d0 + kk], bf16);
      }
      __syncthreads();
      if (tid < 3 * hd) {
        for (int kk = 0; kk < kc; ++kk) {
          const float w = round_to(__ldg(w_qkv + static_cast<size_t>(d0 + kk) * D3 + col), bf16);
#pragma unroll
          for (int a = 0; a < MAXA; ++a)
            if (a < A) p[a] = fmaf(chunk[a * kChunk + kk], w, p[a]);
        }
      }
    }
    if (tid < 3 * hd) {
      const float b = __ldg(b_qkv + col);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
      for (int a = 0; a < MAXA; ++a) {
        if (a < A) {
          float v = round_to(p[a] + b, bf16);
          if (part == 0) v = round_to(v * scale_c, bf16);
          dst[a * ld + c] = v;
        }
      }
    }
    __syncthreads();

    // logits
    for (int idx = tid; idx < A * A; idx += kThreads) {
      const int i = idx / A;
      const int j = idx - i * A;
      float s = 0.f;
      for (int cc = 0; cc < hd; ++cc) s = fmaf(qs[i * ld + cc], ks[j * ld + cc], s);
      ps[i * MAXA + j] = s;
    }
    __syncthreads();

    // softmax over the row's valid keys, one warp per query (P stays f32)
    for (int i = warp; i < A; i += kThreads / 32)
      warp_masked_softmax64(ps + i * MAXA, valid, A, any_valid, 0);
    __syncthreads();

    // attention output o = P_c v (for dW_out) and dv = P_c^T da
    for (int idx = tid; idx < A * hd; idx += kThreads) {
      const int i = idx / hd;
      const int cc = idx - i * hd;
      float o = 0.f, dv = 0.f;
      for (int j = 0; j < A; ++j) {
        o = fmaf(round_to(ps[i * MAXA + j], bf16), vs[j * ld + cc], o);
        dv = fmaf(round_to(ps[j * MAXA + i], bf16), das[j * ld + cc], dv);
      }
      attn[(tok0 + i) * D + h0 + cc] = round_to(o, bf16);
      dqkv[(tok0 + i) * D3 + 2 * D + h0 + cc] = dv;
    }
    // dP = da v^T and dS = P o (dP - rowsum(dP o P)), one warp per query
    for (int i = warp; i < A; i += kThreads / 32) {
      float dp[2], pr[2];
      float r = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        pr[t] = j < A ? ps[i * MAXA + j] : 0.f;
        dp[t] = 0.f;
        if (j < A)
          for (int cc = 0; cc < hd; ++cc) dp[t] = fmaf(das[i * ld + cc], vs[j * ld + cc], dp[t]);
        r += dp[t] * pr[t];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < A) dss[i * MAXA + j] = round_to(pr[t] * (dp[t] - r), bf16);
      }
    }
    __syncthreads();

    // dq = dS k scale, dk = dS^T (q x scale)
    for (int idx = tid; idx < A * hd; idx += kThreads) {
      const int i = idx / hd;
      const int cc = idx - i * hd;
      float dq = 0.f, dk = 0.f;
      for (int j = 0; j < A; ++j) {
        dq = fmaf(dss[i * MAXA + j], ks[j * ld + cc], dq);
        dk = fmaf(dss[j * MAXA + i], qs[j * ld + cc], dk);
      }
      dqkv[(tok0 + i) * D3 + h0 + cc] = dq * scale;
      dqkv[(tok0 + i) * D3 + D + h0 + cc] = dk;
    }
  }

  // dx = dqkv_c . W_qkv^T over all heads (overwrites the parked dattn)
  token_block_product(dqkv + tok0 * D3, D3, D3, w_qkv_t, dx + tok0 * D, A, D,
                      chunk, bf16, false);
}

// C (M x N) = round(X)^T round(Y) for X (T x M), Y (T x N), row-major.
// One block per 64 x 64 tile of C; each thread owns a 4 x 4 sub-tile; the
// loop runs over all T tokens in order, 16 at a time through shared memory.
constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(kThreads)
weight_grad_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ C, int T, int M, int N, int bf16) {
  __shared__ __align__(16) float Xs[BK][BM];
  __shared__ __align__(16) float Ys[BK][BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4;
  const int tn = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < T; t0 += BK) {
    for (int i = tid; i < BK * BM; i += kThreads) {
      const int r = i / BM;
      const int c = i - r * BM;
      const int t = t0 + r;
      Xs[r][c] = (t < T && m0 + c < M)
                     ? round_to(X[static_cast<size_t>(t) * M + m0 + c], bf16) : 0.f;
      Ys[r][c] = (t < T && n0 + c < N)
                     ? round_to(Y[static_cast<size_t>(t) * N + n0 + c], bf16) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[k][tm]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[k][tn]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m0 + tm + i < M && n0 + tn + j < N)
        C[static_cast<size_t>(m0 + tm + i) * N + n0 + tn + j] = acc[i][j];
}

// out[n] = sum_t Y[t, n] (f32, unrounded). Block of 32 x 32 threads per 32
// columns: lane x owns a column, row y sums tokens y, y + 32, ...; the 32
// partial sums are then added in order of y.
__global__ void __launch_bounds__(1024)
column_sum_kernel(const float* __restrict__ Y, float* __restrict__ out, int T,
                  int N) {
  __shared__ float part[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (n < N)
    for (int t = threadIdx.y; t < T; t += 32) s += Y[static_cast<size_t>(t) * N + n];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += part[y][threadIdx.x];
    out[n] = total;
  }
}

template <int MAXA>
cudaError_t launch_rows(const float* x, const unsigned char* mask, const float* g,
                        const float* w_qkv, const float* w_qkv_t, const float* b_qkv,
                        const float* w_out_t, float* dx, float* dqkv, float* attn,
                        int rows, int A, int D, int H, int bf16, cudaStream_t stream) {
  const int ld = D / H + 1;
  const size_t smem = sizeof(float) * (MAXA * kChunk + 4 * MAXA * ld +
                                       2 * MAXA * MAXA);
  cudaError_t err = cudaFuncSetAttribute(row_backward_kernel<MAXA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_backward_kernel<MAXA><<<rows, kThreads, smem, stream>>>(
      x, mask, g, w_qkv, w_qkv_t, b_qkv, w_out_t, dx, dqkv, attn, A, D, H, bf16);
  return cudaGetLastError();
}

cudaError_t launch_weight_grad(const float* X, const float* Y, float* C, int T,
                               int M, int N, int bf16, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  weight_grad_kernel<<<grid, kThreads, 0, stream>>>(X, Y, C, T, M, N, bf16);
  return cudaGetLastError();
}

cudaError_t launch_column_sum(const float* Y, float* out, int T, int N,
                              cudaStream_t stream) {
  column_sum_kernel<<<(N + 31) / 32, dim3(32, 32), 0, stream>>>(Y, out, T, N);
  return cudaGetLastError();
}

}  // namespace

// x, g (rows, A, D) f32; mask (rows, A) bytes, nonzero = valid key;
// w_qkv (D, 3D), w_qkv_t (3D, D) = w_qkv^T, b_qkv (3D), w_out_t (D, D) =
// w_out^T, all f32. Outputs dx (rows, A, D), dw_qkv (D, 3D), db_qkv (3D),
// dw_out (D, D), db_out (D); scratch dqkv (rows*A, 3D) and attn (rows*A, D).
// bf16 != 0 selects bf16 rounding. Takes 1 <= A <= 64, D / num_heads <= 64
// and D <= 512. Returns the first cudaError_t of its five launches (0 on
// success); nothing is launched for bad sizes.
extern "C" int fused_graph_attention_backward(
    const void* x, const void* mask, const void* g, const void* w_qkv,
    const void* w_qkv_t, const void* b_qkv, const void* w_out_t, void* dx,
    void* dqkv, void* attn, void* dw_qkv, void* db_qkv, void* dw_out,
    void* db_out, int rows, int A, int D, int num_heads, int bf16, void* stream) {
  if (rows < 0 || A < 1 || A > 64 || num_heads < 1 || D % num_heads != 0 ||
      D / num_heads > kMaxHeadDim || D > kMaxCols * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* gf = static_cast<const float*>(g);
  const auto* wq = static_cast<const float*>(w_qkv);
  const auto* wqt = static_cast<const float*>(w_qkv_t);
  const auto* bq = static_cast<const float*>(b_qkv);
  const auto* wot = static_cast<const float*>(w_out_t);
  auto* dxf = static_cast<float*>(dx);
  auto* dq = static_cast<float*>(dqkv);
  auto* at = static_cast<float*>(attn);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    if (A <= 32)
      err = launch_rows<32>(xf, m, gf, wq, wqt, bq, wot, dxf, dq, at, rows, A, D, num_heads, bf16, s);
    else
      err = launch_rows<64>(xf, m, gf, wq, wqt, bq, wot, dxf, dq, at, rows, A, D, num_heads, bf16, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int T = rows * A;
  err = launch_weight_grad(xf, dq, static_cast<float*>(dw_qkv), T, D, 3 * D, bf16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_weight_grad(at, gf, static_cast<float*>(dw_out), T, D, D, bf16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_column_sum(dq, static_cast<float*>(db_qkv), T, 3 * D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_column_sum(gf, static_cast<float*>(db_out), T, D, s);
  return static_cast<int>(err);
}
