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
// result is b_out (the TPU kernel leaked its strip's mean there).
//
// In bf16 mode x, the weights, q/k/v, the softmax weights P and the attention
// output are rounded to bf16 at the points where `_fused_kernel` casts to its
// compute dtype; every product accumulates in f32 and the biases stay f32.
//
// What bounds it: at the flagship shape (A=20, D=512, 8 heads) a row needs
// ~42.7 MFLOP against ~82 KB of its own activations plus 4 MB of weights that
// every row shares, so the work is compute-bound once the weights sit in L2.
// This first version is kept simple: one block of 256 threads per row, the
// row's x staged once in shared memory, a loop over heads that projects the
// head's q/k/v with CUDA-core FMAs (weights read through L2), the masked
// softmax one warp per query, and the head's share of the output projection
// accumulated in registers (each thread owns two output columns for all A
// tokens). The TPU tiling (`_pick_packing`, `_pick_strip`, the n % 128
// assert) encoded lane and VMEM limits and is not carried over. Tensor cores
// (wgmma) are left to a later version.
//
// Rows of 33 <= A <= 64 agents (the MAXA = 64 tier) would need 2 x 64
// output-projection partials per thread beside the projection's 64 and
// spill registers. That tier writes each head's attention output to its
// row of `out` instead, reads the whole (A, D) attention output back into
// the shared memory that held x once the heads are done, and runs the
// output projection there, 32 tokens at a time. Each softmax lane owns keys
// lane and lane + 32. Its x rows sit at a constant stride (512 floats), so
// the 64 unrolled token reads take immediate offsets: with the runtime
// stride D the tier ran 3.6x slower. The A <= 32 tiers do not take these
// branches.

#include <cuda_runtime.h>
#include <math.h>

#include "softmax64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kMaxCols = 2;  // output columns per thread: D <= 512

template <int MAXA>
__global__ void __launch_bounds__(kThreads)
fused_graph_attention_kernel(const float* __restrict__ x,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ w_qkv,
                             const float* __restrict__ b_qkv,
                             const float* __restrict__ w_out,
                             const float* __restrict__ b_out,
                             float* __restrict__ out, int A, int D, int H,
                             int bf16) {
  extern __shared__ float smem[];
  const int hd = D / H;
  const int ld = hd + 1;  // padded stride: rows of q/k/v/o fall in distinct banks
  constexpr bool kWide = MAXA > 32;
  // x's row stride in shared memory: a constant in the wide tier, so the
  // 64 unrolled token reads of the projections take immediate offsets
  const int xld = kWide ? kMaxCols * kThreads : D;
  float* xs = smem;                    // MAXA x xld
  float* qs = xs + MAXA * xld;         // MAXA x ld (each of q, k, v, o)
  float* ks = qs + MAXA * ld;
  float* vs = ks + MAXA * ld;
  float* os = vs + MAXA * ld;
  float* ps = os + MAXA * ld;          // MAXA x MAXA
  __shared__ unsigned char valid[MAXA];
  __shared__ int any_valid;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));

  const float* xr = x + static_cast<size_t>(row) * A * D;
  float* orow = out + static_cast<size_t>(row) * A * D;
  for (int i = tid; i < A * D; i += kThreads) {
    if constexpr (kWide)
      xs[i / D * xld + i % D] = round_to(xr[i], bf16);
    else
      xs[i] = round_to(xr[i], bf16);
  }
  if (tid < MAXA) valid[tid] = (tid < A) ? (mask[static_cast<size_t>(row) * A + tid] != 0) : 0;
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int j = 0; j < A; ++j) any |= valid[j];
    any_valid = any;
  }

  float acc[kMaxCols][MAXA];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int a = 0; a < MAXA; ++a) acc[c][a] = 0.f;

  const int D3 = 3 * D;
  for (int h = 0; h < H; ++h) {
    // q_h, k_h, v_h: thread t < 3*hd owns one column for all A tokens
    if (tid < 3 * hd) {
      const int part = tid / hd;
      const int c = tid - part * hd;
      const int col = part * D + h * hd + c;
      float p[MAXA];
#pragma unroll
      for (int a = 0; a < MAXA; ++a) p[a] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float w = round_to(__ldg(w_qkv + static_cast<size_t>(d) * D3 + col), bf16);
#pragma unroll
        for (int a = 0; a < MAXA; ++a)
          if (a < A) p[a] = fmaf(xs[a * xld + d], w, p[a]);
      }
      const float b = __ldg(b_qkv + col);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      const float s = part == 0 ? scale : 1.f;
#pragma unroll
      for (int a = 0; a < MAXA; ++a)
        if (a < A) dst[a * ld + c] = round_to((p[a] + b) * s, bf16);
    }
    __syncthreads();

    // masked logits
    for (int idx = tid; idx < A * A; idx += kThreads) {
      const int i = idx / A;
      const int j = idx - i * A;
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(qs[i * ld + c], ks[j * ld + c], s);
      ps[i * MAXA + j] = s;
    }
    __syncthreads();

    // softmax over the row's valid keys, one warp per query
    for (int i = warp; i < A; i += kThreads / 32) {
      if constexpr (!kWide) {
        const bool ok = lane < A && valid[lane];
        const float s = ok ? ps[i * MAXA + lane] : -INFINITY;
        float m = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const float e = ok ? expf(s - m) : 0.f;
        float sum = e;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane < A) ps[i * MAXA + lane] = any_valid ? round_to(e / sum, bf16) : 0.f;
      } else {
        warp_masked_softmax64(ps + i * MAXA, valid, A, any_valid, bf16);
      }
    }
    __syncthreads();

    // o_h = P v_h
    for (int idx = tid; idx < A * hd; idx += kThreads) {
      const int i = idx / hd;
      const int c = idx - i * hd;
      float o = 0.f;
      for (int j = 0; j < A; ++j) o = fmaf(ps[i * MAXA + j], vs[j * ld + c], o);
      if constexpr (kWide)
        orow[i * D + h * hd + c] = round_to(o, bf16);  // read back after the heads
      else
        os[i * ld + c] = round_to(o, bf16);
    }
    __syncthreads();

    // this head's share of the output projection
    if constexpr (!kWide) {
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc) {
        const int n = tid + cc * kThreads;
        if (n < D) {
          for (int c = 0; c < hd; ++c) {
            const float w = round_to(__ldg(w_out + static_cast<size_t>(h * hd + c) * D + n), bf16);
#pragma unroll
            for (int a = 0; a < MAXA; ++a)
              if (a < A) acc[cc][a] = fmaf(os[a * ld + c], w, acc[cc][a]);
          }
        }
      }
    }
    __syncthreads();  // q/k/v/o/P are overwritten by the next head
  }

  if constexpr (!kWide) {
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int n = tid + cc * kThreads;
      if (n < D) {
        const float b = __ldg(b_out + n);
#pragma unroll
        for (int a = 0; a < MAXA; ++a)
          if (a < A) orow[a * D + n] = acc[cc][a] + b;
      }
    }
  } else {
    // the output projection of all heads at once, from the attention output
    // staged where x was, 32 tokens at a time (the same order of sums)
    for (int i = tid; i < A * D; i += kThreads) xs[i / D * xld + i % D] = orow[i];
    __syncthreads();
    for (int t0 = 0; t0 < A; t0 += 32) {
      float part[kMaxCols][32];
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc)
#pragma unroll
        for (int a = 0; a < 32; ++a) part[cc][a] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc) {
        const int n = tid + cc * kThreads;
        if (n < D) {
          for (int d = 0; d < D; ++d) {
            const float w = round_to(__ldg(w_out + static_cast<size_t>(d) * D + n), bf16);
#pragma unroll
            for (int a = 0; a < 32; ++a)
              if (t0 + a < A) part[cc][a] = fmaf(xs[(t0 + a) * xld + d], w, part[cc][a]);
          }
          const float b = __ldg(b_out + n);
#pragma unroll
          for (int a = 0; a < 32; ++a)
            if (t0 + a < A) orow[(t0 + a) * D + n] = part[cc][a] + b;
        }
      }
    }
  }
}

template <int MAXA>
cudaError_t launch(const float* x, const unsigned char* mask, const float* w_qkv,
                   const float* b_qkv, const float* w_out, const float* b_out,
                   float* out, int rows, int A, int D, int H, int bf16,
                   cudaStream_t stream) {
  const int hd = D / H;
  const int xld = MAXA > 32 ? kMaxCols * kThreads : D;  // as in the kernel
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(MAXA) * xld + 4 * MAXA * (hd + 1) + MAXA * MAXA);
  cudaError_t err = cudaFuncSetAttribute(fused_graph_attention_kernel<MAXA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_graph_attention_kernel<MAXA><<<rows, kThreads, smem, stream>>>(
      x, mask, w_qkv, b_qkv, w_out, b_out, out, A, D, H, bf16);
  return cudaGetLastError();
}

}  // namespace

// x (rows, A, D) f32; mask (rows, A) bytes, nonzero = valid key;
// w_qkv (D, 3D) f32; b_qkv (3D) f32; w_out (D, D) f32; b_out (D) f32;
// out (rows, A, D) f32. bf16 != 0 selects bf16 rounding of the matmul inputs.
// Takes 1 <= A <= 64, D / num_heads <= 64 and D <= 512.
// Returns a cudaError_t (0 on success); nothing is launched for bad sizes.
extern "C" int fused_graph_attention_forward(
    const void* x, const void* mask, const void* w_qkv, const void* b_qkv,
    const void* w_out, const void* b_out, void* out, int rows, int A, int D,
    int num_heads, int bf16, void* stream) {
  if (rows < 0 || A < 1 || A > 64 || num_heads < 1 || D % num_heads != 0 ||
      D / num_heads > kMaxHeadDim || D > kMaxCols * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* wq = static_cast<const float*>(w_qkv);
  const auto* bq = static_cast<const float*>(b_qkv);
  const auto* wo = static_cast<const float*>(w_out);
  const auto* bo = static_cast<const float*>(b_out);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (A <= 8)
    err = launch<8>(xf, m, wq, bq, wo, bo, o, rows, A, D, num_heads, bf16, s);
  else if (A <= 16)
    err = launch<16>(xf, m, wq, bq, wo, bo, o, rows, A, D, num_heads, bf16, s);
  else if (A <= 24)
    err = launch<24>(xf, m, wq, bq, wo, bo, o, rows, A, D, num_heads, bf16, s);
  else if (A <= 32)
    err = launch<32>(xf, m, wq, bq, wo, bo, o, rows, A, D, num_heads, bf16, s);
  else
    err = launch<64>(xf, m, wq, bq, wo, bo, o, rows, A, D, num_heads, bf16, s);
  return static_cast<int>(err);
}
