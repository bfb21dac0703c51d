// Packed masked attention (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_attn_kernel` of
// crowdnav_prediction_attngraph_tpu/ops/masked_attention.py (launched by
// `packed_masked_attention`): for every row (one graph of A agents) and each
// of its H heads, with q, k and v already projected,
//
//   o_h = softmax(q_h k_h^T / sqrt(hd), masked keys left out) v_h
//
// all in f32, with no projections. A row with no valid key has a zero
// output (the TPU kernel spread its attention over its packing strip).
//
// What bounds it: at the edges/s bench shape (rows = 4096, A = 20, D = 512,
// 8 heads) the kernel reads q, k, v and writes out, 671 MB, against 3.4
// GFLOP of products, so it is bound by bytes. The TPU packing (rows packed
// into lane-aligned blocks, A padded to a multiple of 32, heads grouped to
// 128 lanes, whole-row strips) encoded the TPU's tile shapes and is not
// carried over. This first version is kept simple: one block of 128 threads
// per (row, head), q_h, k_h and v_h staged in shared memory with coalesced
// loads (consecutive threads read consecutive features of a token), the
// A x A logits kept in shared memory, the masked softmax one warp per query
// (each lane owns keys lane and lane + 32), and the output written straight
// from P v_h.

#include <cuda_runtime.h>
#include <math.h>

#include "softmax64.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 64;
constexpr int kMaxHeadDim = 64;

__global__ void __launch_bounds__(kThreads)
packed_masked_attention_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const unsigned char* __restrict__ mask,
                               float* __restrict__ out, int A, int D, int H) {
  extern __shared__ float smem[];
  const int hd = D / H;
  const int ld = hd + 1;  // padded stride: rows of q/k/v fall in distinct banks
  float* qs = smem;       // A x ld (each of q, k, v)
  float* ks = qs + A * ld;
  float* vs = ks + A * ld;
  float* ps = vs + A * ld;  // A x A: logits, then P
  __shared__ unsigned char valid[kMaxA];
  __shared__ int any_valid;

  const int row = blockIdx.x / H;
  const int h = blockIdx.x - row * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const size_t base = static_cast<size_t>(row) * A * D + static_cast<size_t>(h) * hd;

  for (int i = tid; i < A * hd; i += kThreads) {
    const int a = i / hd;
    const int c = i - a * hd;
    const size_t g = base + static_cast<size_t>(a) * D + c;
    qs[a * ld + c] = q[g];
    ks[a * ld + c] = k[g];
    vs[a * ld + c] = v[g];
  }
  if (tid < kMaxA) valid[tid] = (tid < A) ? (mask[static_cast<size_t>(row) * A + tid] != 0) : 0;
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int j = 0; j < A; ++j) any |= valid[j];
    any_valid = any;
  }

  // logits
  for (int idx = tid; idx < A * A; idx += kThreads) {
    const int i = idx / A;
    const int j = idx - i * A;
    float s = 0.f;
    for (int c = 0; c < hd; ++c) s = fmaf(qs[i * ld + c], ks[j * ld + c], s);
    ps[i * A + j] = s * scale;
  }
  __syncthreads();

  // softmax over the row's valid keys, one warp per query
  for (int i = warp; i < A; i += kWarps)
    warp_masked_softmax64(ps + i * A, valid, A, any_valid, 0);
  __syncthreads();

  // o_h = P v_h, written in place of the head's columns
  for (int idx = tid; idx < A * hd; idx += kThreads) {
    const int i = idx / hd;
    const int c = idx - i * hd;
    float o = 0.f;
    for (int j = 0; j < A; ++j) o = fmaf(ps[i * A + j], vs[j * ld + c], o);
    out[base + static_cast<size_t>(i) * D + c] = o;
  }
}

}  // namespace

// q, k, v (rows, A, D) f32; mask (rows, A) bytes, nonzero = valid key;
// out (rows, A, D) f32. Takes 1 <= A <= 64 and D / num_heads <= 64.
// Returns a cudaError_t (0 on success); nothing is launched for bad sizes.
extern "C" int packed_masked_attention_forward(const void* q, const void* k,
                                               const void* v, const void* mask,
                                               void* out, int rows, int A, int D,
                                               int num_heads, void* stream) {
  if (rows < 0 || A < 1 || A > kMaxA || num_heads < 1 || D % num_heads != 0 ||
      D / num_heads > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int ld = D / num_heads + 1;
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(A) * ld + A * A);
  cudaError_t err = cudaFuncSetAttribute(packed_masked_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_masked_attention_kernel<<<rows * num_heads, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), A, D, num_heads);
  return static_cast<int>(cudaGetLastError());
}
