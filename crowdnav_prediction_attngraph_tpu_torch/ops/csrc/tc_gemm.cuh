// One tiled matrix-product template for K1 and K2 (sm_90a).
//
//   C (M x N) = op(A) . op(B), f32 accumulation, then an epilogue
//
// op(A) is A stored (M, K) row-major, or A^T of A stored (K, M) (A_T);
// op(B) is B stored (K, N) row-major, or B^T of B stored (N, K) (B_T). These
// three layouts (A.B, A.B^T, A^T.B) cover every product of K1 and K2:
// x.W_qkv, attn.W_out (either layout of W_out), g.W_out^T, dqkv.W_qkv^T and
// the weight gradients x^T.dqkv and attn^T.g, whose K is the token count.
//
// Element type T = __nv_bfloat16: operand tiles are staged in shared memory
// by a STAGES-deep cp.async ring (16-byte copies, ragged edges zero-filled),
// read with ldmatrix (.trans for the transposed operand) and multiplied by
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on the tensor cores.
// T = float (the strict-parity f32 mode): the same ring and tiles, with a
// register-blocked CUDA-core FMA inner product (TF32 would not keep f32).
//
// Every output element is summed over K in one fixed order inside one block:
// no split-K across blocks and no atomics. The weight gradients, whose K is
// the token count, split their K loop over the block's four warp groups and
// add the groups' sums in group order. Two runs give the same bits.
//
// Any sizes: an operand whose stored column count (K or M or N, whichever
// is contiguous) is a multiple of 16 bytes is staged by 16-byte cp.async
// copies, any other by predicated element loads, zero-filled past its edge
// (the same tile, so the same sums in the same order); an output whose row is
// not a multiple of 16 bytes is stored element by element. Base pointers are
// 16-byte aligned (the callers' buffers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: K1's and K2's libraries each keep their own copies of
// these kernels and of the launchers' static flags (an inline function's
// static would otherwise be one symbol for the whole process).
namespace {
namespace tc {

using bf16 = __nv_bfloat16;

// What happens to each f32 accumulator before it is stored: v = acc +
// bias[n]; for the q columns (n < q_cols) v is rounded to bf16 first when
// round_q_input (K2's q = round(round(qkv) * scale_c)) and then scaled.
// The store into an OutT = bf16 output is the final rounding.
struct Epilogue {
  const float* bias;  // (N) or nullptr
  int q_cols;         // 0: no column is scaled
  float q_scale;
  int round_q_input;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float epilogue_value(const Epilogue& e, int n, float acc) {
  float v = e.bias ? acc + e.bias[n] : acc;
  if (n < e.q_cols) {
    if (e.round_q_input) v = __bfloat162float(__float2bfloat16(v));
    v *= e.q_scale;
  }
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile shapes: BM x BN outputs per block, BK of K per stage, WM x WN warps.
template <int BM_, int BN_, int WM_, int WN_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = WM * WN * 32;
};
// Chosen by timing K1 and K2 at 960 x 20 on the H100 (PERF.md):
// 128 x 256, 256 x 128 and 4-warp 128 x 128 tiles were slower for the
// large products; for the weight gradients 128 x 64 tiles (warp tile
// 64 x 64) beat 64 x 64, 64 x 128 and 128 x 128.
using BigTile = Shape<128, 128, 2, 4>;    // 256 threads, warp tile 64 x 32
using SmallTile = Shape<64, 64, 2, 2>;    // 128 threads, warp tile 32 x 32
using LongKTile = Shape<128, 64, 2, 1>;   // per K group: 64 threads, warp tile 64 x 64
constexpr int kLongKSplit = 4;

template <typename T>
struct Stage {
  static constexpr int BK = std::is_same<T, bf16>::value ? 32 : 16;
  static constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kPad = kChunk;             // row padding: 16 bytes
  static constexpr int kStages = std::is_same<T, bf16>::value ? 4 : 3;
};

// Shared-memory pitch (elements) and row count of an operand tile stored
// with `rows` x `cols` elements in its global layout.
template <typename T, int ROWS, int COLS>
struct TileLayout {
  static constexpr int kRows = ROWS, kCols = COLS;
  static constexpr int kPitch = COLS + Stage<T>::kPad;
  static constexpr int kElems = ROWS * kPitch;
};

// Copy one tile (rows r0.., cols c0.. of a row-major (nrows, ncols) array
// with leading dimension ld) into shared memory, zero-filling outside: by
// 16-byte cp.async copies when every row starts on 16 bytes (ld a multiple
// of the copy), else by element loads and stores (visible to the block
// after the barrier that precedes the stage's use, like the copies).
template <typename T, class L, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int ld, int r0,
                                          int c0, int nrows, int ncols, int tid) {
  constexpr int CH = Stage<T>::kChunk;
  constexpr int kPerRow = L::kCols / CH;
  constexpr int kTotal = L::kRows * kPerRow;
  if (ld % CH != 0) {
    for (int i = tid; i < L::kRows * L::kCols; i += NT) {
      const int r = i / L::kCols, c = i - r * L::kCols;
      const bool ok = (r0 + r < nrows) && (c0 + c < ncols);
      dst[r * L::kPitch + c] =
          ok ? src[static_cast<size_t>(r0 + r) * ld + (c0 + c)] : from_float<T>(0.f);
    }
    return;
  }
  for (int i = tid; i < kTotal; i += NT) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * CH;
    const bool ok = (r0 + r < nrows) && (c0 + c < ncols);
    const T* s = ok ? src + static_cast<size_t>(r0 + r) * ld + (c0 + c) : src;
    cp_async16(dst + r * L::kPitch + c, s, ok);
  }
}

// acc (R values per thread) of group 0 += those of groups 1 .. KSPLIT-1,
// added in group order through shared memory (after every group's loads).
template <int KSPLIT, int NT, int R>
__device__ __forceinline__ void reduce_groups(float* acc, unsigned char* smem, int group,
                                              int tid) {
  float* part = reinterpret_cast<float*>(smem);
  __syncthreads();
  if (group > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[((group - 1) * R + r) * NT + tid] = acc[r];
  }
  __syncthreads();
  if (group == 0) {
    for (int g = 0; g < KSPLIT - 1; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += part[(g * R + r) * NT + tid];
    }
  }
}

__device__ __forceinline__ void group_barrier(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// The output tile through shared memory: put(tile, pitch) writes each
// thread's values into the BM x BN tile between the two barriers that this
// calls, then the tile goes out as 16-byte row pieces (C 16-byte aligned;
// element by element when a row of N is not a multiple of 16 bytes), rows
// and columns past M and N left out.
template <typename OutT, int BM, int BN, int NT, class Put>
__device__ __forceinline__ void store_tile(OutT* __restrict__ C, int M, int N, int m0, int n0,
                                           unsigned char* smem, int barrier, int tid, Put put) {
  constexpr int V = 16 / sizeof(OutT), kPitch = BN + V;
  OutT* cs = reinterpret_cast<OutT*>(smem);
  group_barrier(barrier, NT);  // every warp is done with the operand ring
  put(cs, kPitch);
  group_barrier(barrier, NT);
  if (N % V != 0) {
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = i / BN, c = i - r * BN;
      const int m = m0 + r, n = n0 + c;
      if (m < M && n < N) C[static_cast<size_t>(m) * N + n] = cs[r * kPitch + c];
    }
    return;
  }
  for (int i = tid; i < BM * BN / V; i += NT) {
    const int r = i / (BN / V), c = (i - r * (BN / V)) * V;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(C + static_cast<size_t>(m) * N + n) =
          *reinterpret_cast<const uint4*>(cs + r * kPitch + c);
  }
}

// One product of a launch: C (M x N) = op(A) . op(B), then the epilogue.
template <typename T, typename OutT>
struct Problem {
  const T* A;
  const T* B;
  OutT* C;
  int M, N, K;
  Epilogue epi;
};

// One block per BM x BN output tile of one of the launch's (up to two)
// problems: blocks [0, tiles0) take p0's tiles, the rest p1's, row-major.
// KSPLIT groups of S::kThreads threads each take every KSPLIT-th k tile,
// with their own cp.async ring and barrier; the groups' sums are then added
// in group order in shared memory. The order of every sum is fixed.
template <typename T, typename OutT, bool A_T, bool B_T, class S, int KSPLIT>
__global__ void __launch_bounds__(S::kThreads * KSPLIT)
gemm_kernel(Problem<T, OutT> p0, Problem<T, OutT> p1, int tiles0) {
  constexpr int BM = S::BM, BN = S::BN, NT = S::kThreads;
  constexpr int BK = Stage<T>::BK, STAGES = Stage<T>::kStages;
  // A tile as stored: (BM, BK) or, transposed, (BK, BM); B: (BK, BN) or (BN, BK)
  using LA = std::conditional_t<A_T, TileLayout<T, BK, BM>, TileLayout<T, BM, BK>>;
  using LB = std::conditional_t<B_T, TileLayout<T, BN, BK>, TileLayout<T, BK, BN>>;
  constexpr int kRing = STAGES * (LA::kElems + LB::kElems);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const bool second = blockIdx.x >= tiles0;
  const T* __restrict__ A = second ? p1.A : p0.A;
  const T* __restrict__ B = second ? p1.B : p0.B;
  OutT* __restrict__ C = second ? p1.C : p0.C;
  const int M = second ? p1.M : p0.M, N = second ? p1.N : p0.N, K = second ? p1.K : p0.K;
  const Epilogue epi = second ? p1.epi : p0.epi;
  const int tile = second ? blockIdx.x - tiles0 : blockIdx.x;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (tile / tiles_n) * BM;
  const int n0 = (tile % tiles_n) * BN;

  const int group = threadIdx.x / NT;
  const int tid = threadIdx.x % NT;  // thread within the group
  T* As = reinterpret_cast<T*>(smem_raw) + group * kRing;
  T* Bs = As + STAGES * LA::kElems;
  const int nk = (K + BK - 1) / BK;
  const int nk_g = nk > group ? (nk - group + KSPLIT - 1) / KSPLIT : 0;  // this group's tiles

  auto load_stage = [&](int stage, int it) {
    const int k0 = (group + it * KSPLIT) * BK;
    T* as = As + stage * LA::kElems;
    T* bs = Bs + stage * LB::kElems;
    if constexpr (A_T)
      load_tile<T, LA, NT>(as, A, M, k0, m0, K, M, tid);
    else
      load_tile<T, LA, NT>(as, A, K, m0, k0, M, K, tid);
    if constexpr (B_T)
      load_tile<T, LB, NT>(bs, B, K, n0, k0, N, K, tid);
    else
      load_tile<T, LB, NT>(bs, B, N, k0, n0, K, N, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk_g) load_stage(s, s);
    cp_async_commit();
  }

  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int WTM = BM / S::WM, WTN = BN / S::WN;  // warp tile
    constexpr int MI = WTM / 16, NI = WTN / 8;
    static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at a time");
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = (warp / S::WN) * WTM, wn = (warp % S::WN) * WTN;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    // ldmatrix lane roles: matrix q = lane / 8 of the x4, row r = lane % 8
    const int q = lane >> 3, r8 = lane & 7;

    for (int it = 0; it < nk_g; ++it) {
      cp_async_wait<STAGES - 2>();
      group_barrier(1 + group, NT);
      if (it + STAGES - 1 < nk_g) load_stage((it + STAGES - 1) % STAGES, it + STAGES - 1);
      cp_async_commit();
      const T* as = As + (it % STAGES) * LA::kElems;
      const T* bs = Bs + (it % STAGES) * LB::kElems;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int mb = wm + i * 16;
          if constexpr (A_T)  // stored [k][m]: matrices (m+0|8, k+0|8) by q
            ldmatrix_x4_trans(af[i], as + (kk + r8 + (q >> 1) * 8) * LA::kPitch + mb + (q & 1) * 8);
          else                // stored [m][k]
            ldmatrix_x4(af[i], as + (mb + r8 + (q & 1) * 8) * LA::kPitch + kk + (q >> 1) * 8);
        }
        unsigned bfr[NI][2];
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          const int nb = wn + j * 8;
          unsigned r[4];
          if constexpr (B_T)  // stored [n][k]: (n+0, k+0), (n+0, k+8), (n+8, k+0), (n+8, k+8)
            ldmatrix_x4(r, bs + (nb + r8 + (q >> 1) * 8) * LB::kPitch + kk + (q & 1) * 8);
          else                // stored [k][n]: the same four, transposed
            ldmatrix_x4_trans(r, bs + (kk + r8 + (q & 1) * 8) * LB::kPitch + nb + (q >> 1) * 8);
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
    }
    cp_async_wait<0>();
    if constexpr (KSPLIT > 1)
      reduce_groups<KSPLIT, NT, MI * NI * 4>(&acc[0][0][0], smem_raw, group, tid);
    if (group != 0) return;

    // accumulator (i, j): rows g and g + 8, columns 2t and 2t + 1
    const int g = lane >> 2, t = lane & 3;
    store_tile<OutT, BM, BN, NT>(C, M, N, m0, n0, smem_raw, 1, tid, [&](OutT* cs, int pitch) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm + i * 16 + g + h * 8, c = wn + j * 8 + 2 * t;
            // columns past N are not stored (their bias index is clamped)
            const int n = n0 + c;
            const float v0 = epilogue_value(epi, min(n, N - 1), acc[i][j][2 * h]);
            const float v1 = epilogue_value(epi, min(n + 1, N - 1), acc[i][j][2 * h + 1]);
            if constexpr (std::is_same<OutT, bf16>::value)
              *reinterpret_cast<__nv_bfloat162*>(cs + r * pitch + c) = __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(cs + r * pitch + c) = make_float2(v0, v1);
          }
    });
  } else {
    // f32: thread (tr, tc) of a (NT/16) x 16 grid owns rows tr + i*(NT/16)
    // and columns tc + j*16 of the block tile
    constexpr int GR = NT / 16;
    constexpr int TM = BM / GR, TN = BN / 16;
    const int tr = tid / 16, tc = tid % 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int it = 0; it < nk_g; ++it) {
      cp_async_wait<STAGES - 2>();
      group_barrier(1 + group, NT);
      if (it + STAGES - 1 < nk_g) load_stage((it + STAGES - 1) % STAGES, it + STAGES - 1);
      cp_async_commit();
      const T* as = As + (it % STAGES) * LA::kElems;
      const T* bs = Bs + (it % STAGES) * LB::kElems;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = tr + i * GR;
          a[i] = A_T ? as[k * LA::kPitch + m] : as[m * LA::kPitch + k];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tc + j * 16;
          b[j] = B_T ? bs[n * LB::kPitch + k] : bs[k * LB::kPitch + n];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    if constexpr (KSPLIT > 1)
      reduce_groups<KSPLIT, NT, TM * TN>(&acc[0][0], smem_raw, group, tid);
    if (group != 0) return;
    store_tile<OutT, BM, BN, NT>(C, M, N, m0, n0, smem_raw, 1, tid, [&](OutT* cs, int pitch) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int r = tr + i * GR, c = tc + j * 16;
          cs[r * pitch + c] = from_float<OutT>(epilogue_value(epi, min(n0 + c, N - 1), acc[i][j]));
        }
    });
  }
}

template <typename T, bool A_T, bool B_T, class S, int KSPLIT>
constexpr size_t gemm_smem_bytes() {
  constexpr int BK = Stage<T>::BK;
  using LA = std::conditional_t<A_T, TileLayout<T, BK, S::BM>, TileLayout<T, S::BM, BK>>;
  using LB = std::conditional_t<B_T, TileLayout<T, S::BN, BK>, TileLayout<T, BK, S::BN>>;
  constexpr size_t ring = sizeof(T) * Stage<T>::kStages * (LA::kElems + LB::kElems) * KSPLIT;
  // the groups' partial sums and the output tile share the rings' memory
  // once the loads are done
  constexpr size_t partial = sizeof(float) * (KSPLIT - 1) * S::BM * S::BN;
  constexpr size_t tile = sizeof(float) * S::BM * (S::BN + 4);
  constexpr size_t most = ring > partial ? ring : partial;
  return most > tile ? most : tile;
}

// Allows `kernel` up to `bytes` of dynamic shared memory, once per device
// (`done` is the caller's static mask of devices already set).
inline cudaError_t allow_smem(const void* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <class S>
int tiles_of(int M, int N) {
  return ((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

template <typename T, typename OutT, bool A_T, bool B_T, class S, int KSPLIT = 1>
cudaError_t launch_gemm_shape(const Problem<T, OutT>& p0, const Problem<T, OutT>& p1, int count,
                              cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<T, A_T, B_T, S, KSPLIT>();
  auto kernel = gemm_kernel<T, OutT, A_T, B_T, S, KSPLIT>;
  static unsigned smem_set = 0;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), static_cast<int>(smem),
                               smem_set);
  if (err != cudaSuccess) return err;
  const int tiles0 = tiles_of<S>(p0.M, p0.N);
  const int tiles = tiles0 + (count > 1 ? tiles_of<S>(p1.M, p1.N) : 0);
  kernel<<<tiles, S::kThreads * KSPLIT, smem, stream>>>(p0, p1, tiles0);
  return cudaGetLastError();
}

// C = op(A) . op(B) with the epilogue: 128 x 128 tiles when they give at
// least one block per SM of the card (132), else 64 x 64 tiles.
template <typename T, typename OutT, bool A_T, bool B_T>
cudaError_t gemm(const T* A, const T* B, OutT* C, int M, int N, int K, const Epilogue& epi,
                 cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const Problem<T, OutT> p{A, B, C, M, N, K, epi};
  if (tiles_of<BigTile>(M, N) >= 132)
    return launch_gemm_shape<T, OutT, A_T, B_T, BigTile>(p, p, 1, stream);
  return launch_gemm_shape<T, OutT, A_T, B_T, SmallTile>(p, p, 1, stream);
}

// Two products with the same operand types and layouts whose K is long and
// whose outputs are small (K2's weight gradients, K = tokens): one launch,
// 128 x 64 tiles, each block's K loop split over 4 groups of 2 warps.
template <typename T, bool A_T, bool B_T>
cudaError_t gemm_pair_long_k(const Problem<T, float>& p0, const Problem<T, float>& p1,
                             cudaStream_t stream) {
  return launch_gemm_shape<T, float, A_T, B_T, LongKTile, kLongKSplit>(p0, p1, 2, stream);
}

// Writes bf16 copies of up to four f32 arrays in one launch (K1's and K2's
// operands that arrive in f32: x, g and the weights), 8 values a thread at
// a time: two 16-byte loads, one 16-byte store; an array's last n % 8
// values one at a time. Each pointer is 16-byte aligned.
struct ConvertJob {
  const float* src[4];
  bf16* dst[4];
  long n[4];
};

__device__ __forceinline__ void convert8(const float* __restrict__ src, bf16* __restrict__ dst,
                                         long i, long n) {
  if (8 * i + 8 > n) {
    for (long e = 8 * i; e < n; ++e) dst[e] = __float2bfloat16(src[e]);
    return;
  }
  const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
  __nv_bfloat162 o[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  reinterpret_cast<uint4*>(dst)[i] = *reinterpret_cast<uint4*>(o);
}

__global__ void __launch_bounds__(256) convert_kernel(ConvertJob job) {
  const long n0 = (job.n[0] + 7) / 8, n1 = (job.n[1] + 7) / 8, n2 = (job.n[2] + 7) / 8,
             n3 = (job.n[3] + 7) / 8;
  const long total = n0 + n1 + n2 + n3;
  for (long i = blockIdx.x * 256L + threadIdx.x; i < total; i += 256L * gridDim.x) {
    // constant indices into the job, so it stays in the parameter space
    if (i < n0)
      convert8(job.src[0], job.dst[0], i, job.n[0]);
    else if (i < n0 + n1)
      convert8(job.src[1], job.dst[1], i - n0, job.n[1]);
    else if (i < n0 + n1 + n2)
      convert8(job.src[2], job.dst[2], i - n0 - n1, job.n[2]);
    else
      convert8(job.src[3], job.dst[3], i - n0 - n1 - n2, job.n[3]);
  }
}

inline cudaError_t convert(const ConvertJob& job, cudaStream_t stream) {
  long total = 0;
  for (int a = 0; a < 4; ++a) total += (job.n[a] + 7) / 8;
  if (total == 0) return cudaSuccess;
  long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  convert_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(job);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
