// Packed masked attention (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_attn_kernel` of
// crowdnav_prediction_attngraph_tpu/ops/masked_attention.py (launched by
// `packed_masked_attention`): for every row (one graph of A agents) and each
// of its H heads, with q, k and v already projected,
//
//   o_h = softmax(q_h k_h^T / sqrt(hd), masked keys left out) v_h
//
// with no projections. q, k and v are f32 or bf16 (read as such, computed in
// f32, as the TPU kernel casts them); the output is f32. A row with no valid
// key has a zero output (the TPU kernel spread its attention over its
// packing strip). Any A >= 1 and any head dim.
//
// What bounds it: at the edges/s bench shape (rows = 4096, A = 20, D = 512,
// 8 heads, f32) the kernel reads q, k, v and writes out, 671 MB, against 3.4
// GFLOP of products, so it is bound by bytes, but only if the products
// overlap the loads and stay off the shared-memory pipe: a 16-byte shared
// load costs a warp 4 of the SM's shared-memory cycles, broadcast or not, so
// each one has to feed many FMAs. The design:
//   * persistent blocks of two warps: each block walks a strided list of
//     work units, a unit being (row, head, tile of up to 8 Tq queries); a
//     unit is one step per tile of up to 4T keys (T = 5, Tq = 3 cover
//     A = 20 in one step up to head dim 64), with an online softmax across the steps (a
//     running max and sum, the accumulator rescaled);
//   * the two warps fill a ring of two stages in shared memory with 16-byte
//     cp.async copies of a step's q, k and v rows, the next step's copies in
//     flight while a step computes, one 64-thread barrier a step; a block
//     needs ~36 KB at the bench shape, so 12 warps share an SM;
//   * rows of 16-byte chunks XOR-swizzled by a hash of the row index, so
//     shared memory stays 16-byte aligned and the float4 patterns below are
//     free of bank conflicts;
//   * each warp takes every other query of the tile; its lanes are a
//     4 x 4 x 2 grid (query groups x key groups x feature halves), each lane
//     a Tq x T tile of logits in registers, Tq + T float4 loads feeding
//     4 Tq T FMAs per 16-byte chunk, the halves summed by one shuffle;
//   * the softmax runs on the tiles in registers (two shuffles per row
//     reduction) in base 2, with the scale folded into one multiply;
//   * P v: the same lane keeps its Tq queries and takes the feature chunks
//     of its (key group, half), so the running max, sum and rescale of each
//     query never leave the lane; P goes through a small shared buffer a
//     warp, and each valid key costs a load of P and one float4 of v per
//     chunk; masked keys are skipped (a warp-uniform loop over the valid
//     keys), never multiplied by 0, so an inf or NaN in their v cannot
//     reach a sum;
//   * the output goes out with 16-byte stores straight from registers;
//   * fixed order everywhere, no atomics: two runs give the same bits.
// T is a template parameter set by the head dim alone, the largest that
// keeps a lane's P v accumulators in registers: T = 5 (Tq = 3, 2 float4
// chunks) up to head dim 64, T = 4 (Tq = 2, 4 chunks) up to 128, T = 2
// (Tq = 1, 8 chunks) up to 256.
// Head dims past 256 (the kSplit variants, T = 2) are cut into column
// chunks of 256: a unit is then (row, head, query tile, output column
// chunk), and each key tile takes one step per column chunk, which stages
// that chunk of q and k and adds its part of each logit to the lane's
// tile in registers; the last of them also stages the output chunk of v,
// and the softmax and P v run there, as for a head of up to 256. The logits
// are recomputed for each output chunk; the parts are added in chunk order,
// so two runs still give the same bits.
// bf16 q, k and v are staged as bf16 by the same 16-byte copies (head dim a
// multiple of 8) and converted to f32 as they are read. Inputs that cannot
// take the 16-byte copies (a head dim that is not a multiple of 4, or 8 in
// bf16, or a pointer that is not 16-byte aligned) take the same kernel with
// plain loads, eight in flight a thread, converted to f32 and padded to a
// multiple of 4 features with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 2;  // warps a block, sharing one unit's stages
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // the next step's copies fly while one computes
constexpr int kMaxChunkDim = 256;  // head dims past this are split
constexpr int kPSlot = 8;         // floats per (key, query group) in P
constexpr int kSmemBudget = 232448;  // bytes of shared memory a block may use

// How a stage is filled: 16-byte cp.async of f32 (head dim % 4 == 0,
// aligned pointers) or of bf16 (head dim % 8 == 0, aligned), or plain loads
// of either converted to f32 (any other input).
enum Mode { kF32Vec = 0, kBf16Vec = 1, kPlain = 2 };

// queries of a lane's logit tile for T keys: the 4T queries of a key tile's
// worth, shared by the warps, over the lanes' 4 query groups
__host__ __device__ constexpr int tile_queries(int T) {
  return ((4 * T + kWarps - 1) / kWarps + 3) / 4;
}

// float4 chunks of a head a lane can accumulate in P v for Tq queries
__host__ __device__ constexpr int max_chunks(int tq) { return tq == 1 ? 8 : (tq == 2 ? 4 : 2); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  float* out;
  int A, D, hd, H;
  int bf16;     // inputs are bf16 (read by the plain-load mode)
  int hdp;      // head dim padded to a multiple of 4
  int cw;       // columns of a staged chunk: hdp, or 256 when split
  int ncc;      // column chunks, ceil(hd / cw) (1 unless split)
  int nch;      // 16-byte chunks of a staged head, hdp / 4 (unsplit)
  int cpl;      // chunks a lane accumulates in P v, ceil(nch / 8)
  int qtile;    // queries of a unit, 4 Tq kWarps
  int ktile;    // keys of a step, 4 T
  int qrows;    // stage rows for queries, min(qtile, A)
  int krows;    // stage rows for keys (k, and again v), min(ktile, A)
  int nqt;      // query tiles per row
  int nkt;      // key tiles per unit (steps)
  int units;    // rows x H x nqt x ncc
  int Wp;       // stage row stride (elements), 128 bytes or a multiple
  int stage_bytes;  // (qrows + 2 krows) rows of Wp elements
  float scale2;     // log2(e) / sqrt(hd)
};

// A step: key tile kt of a unit and, when split, its column chunk sub
// (q and k columns [sub cw, ..)); oc is the unit's output column chunk (v
// and the output, columns [oc cw, ..)). Unsplit, sub = oc = 0 and a chunk
// is the whole head.
struct Step {
  int row, head, q0, qn, k0, kn;
  int sub, oc;
  int wqk, wv;  // real columns of this step's q and k chunk and of v's
  bool first, last, last_sub;
};

template <bool kSplit>
__device__ __forceinline__ Step decode(const Params& p, int unit, int s) {
  Step st;
  const int ncc = kSplit ? p.ncc : 1;
  const int kt = kSplit ? s / ncc : s;
  st.sub = kSplit ? s - kt * ncc : 0;
  st.oc = kSplit ? unit % ncc : 0;
  const int u = kSplit ? unit / ncc : unit;
  const int qt = u % p.nqt;
  const int rh = u / p.nqt;
  st.head = rh % p.H;
  st.row = rh / p.H;
  st.q0 = qt * p.qtile;
  st.qn = min(p.qtile, p.A - st.q0);
  st.k0 = kt * p.ktile;
  st.kn = min(p.ktile, p.A - st.k0);
  st.first = kt == 0;
  st.last = kt == p.nkt - 1;
  st.last_sub = st.sub == ncc - 1;
  st.wqk = kSplit ? min(p.cw, p.hd - st.sub * p.cw) : p.hd;
  st.wv = kSplit ? min(p.cw, p.hd - st.oc * p.cw) : p.hd;
  return st;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// 2^x (ex2.approx: ~2 ulp; 0 for x = -inf)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Staged element: f32, or bf16 for the bf16 16-byte copies.
template <int kMode>
using Elem = std::conditional_t<kMode == kBf16Vec, __nv_bfloat16, float>;

// Element offset, in stage row r, of the 4 features of chunk c. Rows are
// 16-byte chunks XOR-swizzled by a hash of r; the key rows a quarter-warp
// reads at once are r0 + {0, T, 2T, 3T}: r & 7 keeps them in distinct bank
// groups for T != 4, r ^ (r >> 3) for T == 4.
template <int kMode, int T>
__device__ __forceinline__ int swz(int r, int c) {
  const int h = (T == 4 ? (r ^ (r >> 3)) : r) & 7;
  if constexpr (kMode == kBf16Vec)
    return (((c >> 1) ^ h) << 3) | ((c & 1) << 2);  // 8 bf16 a 16-byte chunk
  else
    return (c ^ h) << 2;
}

// The 4 staged features at e, as f32
template <int kMode>
__device__ __forceinline__ float4 load4(const Elem<kMode>* e) {
  if constexpr (kMode == kBf16Vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(e);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return *reinterpret_cast<const float4*>(e);
  }
}

// Stage rows [0, qrows) hold the unit's queries, [qrows, qrows + krows) the
// step's keys' k and the next krows their v, hdp features each (split: the
// step's column chunk of q and k, and v's output chunk on the last step of
// a key tile only); rows past qn or kn are not filled and never reach a
// result.
template <int kMode, int T, bool kSplit>
__device__ __forceinline__ void issue_step(const Params& p, Elem<kMode>* stage, const Step& st,
                                           int tid) {
  using E = Elem<kMode>;
  const size_t head0 = static_cast<size_t>(st.head) * p.hd;
  const int regions = kSplit && !st.last_sub ? 2 : 3;
  if constexpr (kMode != kPlain) {
    // 16-byte copies, 4 f32 or 8 bf16 features each, region by region; a
    // thread's (row, copy) pairs advance by kThreads copies, no division
    constexpr int kPer = kMode == kBf16Vec ? 8 : 4;
    int per_row = (kSplit ? st.wqk : p.hdp) / kPer;
    int dr = kThreads / per_row, de = kThreads - dr * per_row;
    int r0 = 0, e0 = tid;
    while (e0 >= per_row) {
      e0 -= per_row;
      ++r0;
    }
#pragma unroll
    for (int region = 0; region < 3; ++region) {
      if (region >= regions) break;
      if (kSplit && region == 2 && st.wv != st.wqk) {  // v's chunk has its own width
        per_row = st.wv / kPer;
        dr = kThreads / per_row;
        de = kThreads - dr * per_row;
        r0 = 0;
        e0 = tid;
        while (e0 >= per_row) {
          e0 -= per_row;
          ++r0;
        }
      }
      const int nr = region == 0 ? st.qn : st.kn;
      const int tok0 = region == 0 ? st.q0 : st.k0;
      const int col0 = kSplit ? (region == 2 ? st.oc : st.sub) * p.cw : 0;
      const E* src = static_cast<const E*>(region == 0 ? p.q : (region == 1 ? p.k : p.v)) +
                     (static_cast<size_t>(st.row) * p.A + tok0) * p.D + head0 + col0;
      const int sr0 = region == 0 ? 0 : p.qrows + (region - 1) * p.krows;
      int r = r0, e = e0;
#pragma unroll 4
      for (; r < nr;) {
        const int sr = sr0 + r;
        cp_async16(stage + sr * p.Wp + swz<kMode, T>(sr, kPer / 4 * e),
                   src + static_cast<size_t>(r) * p.D + kPer * e);
        r += dr;
        e += de;
        if (e >= per_row) {
          e -= per_row;
          ++r;
        }
      }
    }
  } else {
    // plain loads, 8 in flight a thread, then the stores; padded features 0
    const int sw = kSplit ? p.cw : p.hdp;  // staged width
    const int nrows = p.qrows + (regions - 1) * p.krows;
    const int total = nrows * sw;
    for (int base = tid; base < total; base += kThreads * 8) {
      float val[8];
      int dst[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = base + kThreads * i;
        val[i] = 0.f;
        dst[i] = -1;
        if (idx < total) {
          const int sr = idx / sw;
          const int e = idx - sr * sw;
          const int region = sr < p.qrows ? 0 : (sr < p.qrows + p.krows ? 1 : 2);
          const int r = region == 0 ? sr : sr - p.qrows - (region - 1) * p.krows;
          if (r < (region == 0 ? st.qn : st.kn)) {
            const int tok = (region == 0 ? st.q0 : st.k0) + r;
            const int col0 = kSplit ? (region == 2 ? st.oc : st.sub) * p.cw : 0;
            const size_t off =
                (static_cast<size_t>(st.row) * p.A + tok) * p.D + head0 + col0 + e;
            const void* src = region == 0 ? p.q : (region == 1 ? p.k : p.v);
            dst[i] = sr * p.Wp + swz<kMode, T>(sr, e >> 2) + (e & 3);
            if (e < (region == 2 ? st.wv : st.wqk))
              val[i] = p.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[off])
                              : static_cast<const float*>(src)[off];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (dst[i] >= 0) stage[dst[i]] = val[i];
    }
  }
}

template <int kMode, int T, bool kSplit>
__global__ void __launch_bounds__(kThreads)
packed_masked_attention_kernel(const Params p) {
  constexpr int TQ = tile_queries(T);
  constexpr int kCpl = max_chunks(TQ);
  using E = Elem<kMode>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;  // this warp takes the tile's queries kWarps slot + w
  const auto stage_at = [&](int i) {
    return reinterpret_cast<E*>(smem + static_cast<size_t>(i) * p.stage_bytes);
  };
  float* pbuf = reinterpret_cast<float*>(smem + static_cast<size_t>(kStages) * p.stage_bytes) +
                w * p.ktile * 4 * kPSlot;

  // lane grid: query group qg (TQ query slots), key group kg (T keys) and
  // feature half fh in the logits; in P v the lane keeps qg and takes the
  // feature chunks fg + 8 u, fg = 4 fh + kg
  const int kg = lane & 3;
  const int qg = (lane >> 2) & 3;
  const int fh = lane >> 4;
  const int fg = 4 * fh + kg;

  const int my_units =
      static_cast<int>(blockIdx.x) < p.units ? (p.units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int unit_steps = kSplit ? p.nkt * p.ncc : p.nkt;
  const int nsteps = my_units * unit_steps;

  float acc[TQ][kCpl][4];
  float m[TQ], l[TQ];
  float sc[TQ][T];  // the lane's logit tile (split: summed over a key tile's steps)

  // the step s of this block: its unit, key tile and column chunk
  const auto step_of = [&](int s) {
    const int u = s / unit_steps;
    return decode<kSplit>(p, blockIdx.x + u * gridDim.x, s - u * unit_steps);
  };
  const auto mask_of = [&](const Step& st) -> unsigned char {
    return lane < st.kn ? p.mask[static_cast<size_t>(st.row) * p.A + st.k0 + lane] : 0;
  };

  Step st_next = step_of(0);
  if (nsteps > 0) issue_step<kMode, T, kSplit>(p, stage_at(0), st_next, tid);
  cp_async_commit();
  unsigned char mv_next = nsteps > 0 ? mask_of(st_next) : 0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s staged; both warps done with step s - 1
    const Step st = st_next;
    const unsigned char mv = mv_next;
    if (s + 1 < nsteps) {  // stage step s + 1 into the stage step s - 1 used
      st_next = step_of(s + 1);
      mv_next = mask_of(st_next);
      issue_step<kMode, T, kSplit>(p, stage_at((s + 1) % kStages), st_next, tid);
      cp_async_commit();
    }
    const E* stage = stage_at(s % kStages);
    if (st.first && st.sub == 0) {
#pragma unroll
      for (int a = 0; a < TQ; ++a) {
        m[a] = -INFINITY;
        l[a] = 0.f;
#pragma unroll
        for (int u = 0; u < kCpl; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][u][e] = 0.f;
      }
    }

    // logits: this lane's TQ x T tile over its half of the feature chunks;
    // a slot past the staged rows reads row 0 of its region, never a result
    int qrow[TQ], krow[T];
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const int i = kWarps * (qg * TQ + a) + w;
      qrow[a] = i < p.qrows ? i : 0;
    }
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const int j = kg * T + b;
      krow[b] = p.qrows + (j < p.krows ? j : 0);
    }
    if (st.sub == 0) {
#pragma unroll
      for (int a = 0; a < TQ; ++a)
#pragma unroll
        for (int b = 0; b < T; ++b) sc[a][b] = 0.f;
    }
    {
      const int nch = kSplit ? (st.wqk + 3) >> 2 : p.nch;
      const int nhalf = (nch + 1) >> 1;
#pragma unroll 1
      for (int ci = 0; ci < nhalf; ++ci) {
        const int c = 2 * ci + fh;
        if (c < nch) {
          float4 qv[TQ], kv[T];
#pragma unroll
          for (int a = 0; a < TQ; ++a) {
            const int r = qrow[a];
            qv[a] = load4<kMode>(stage + r * p.Wp + swz<kMode, T>(r, c));
          }
#pragma unroll
          for (int b = 0; b < T; ++b) {
            const int r = krow[b];
            kv[b] = load4<kMode>(stage + r * p.Wp + swz<kMode, T>(r, c));
          }
#pragma unroll
          for (int a = 0; a < TQ; ++a)
#pragma unroll
            for (int b = 0; b < T; ++b) {
              sc[a][b] = fmaf(qv[a].x, kv[b].x, sc[a][b]);
              sc[a][b] = fmaf(qv[a].y, kv[b].y, sc[a][b]);
              sc[a][b] = fmaf(qv[a].z, kv[b].z, sc[a][b]);
              sc[a][b] = fmaf(qv[a].w, kv[b].w, sc[a][b]);
            }
        }
      }
    }
    if (kSplit && !st.last_sub) continue;  // the key tile's next column chunk
#pragma unroll
    for (int a = 0; a < TQ; ++a)
#pragma unroll
      for (int b = 0; b < T; ++b) sc[a][b] += __shfl_xor_sync(0xffffffffu, sc[a][b], 16);

    // online softmax of this key tile, base 2; p replaces the logits
    const unsigned vbits = __ballot_sync(0xffffffffu, mv != 0);

    bool valid[T];
#pragma unroll
    for (int b = 0; b < T; ++b) valid[b] = (vbits >> (kg * T + b)) & 1u;
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < T; ++b) {
        sc[a][b] = valid[b] ? sc[a][b] * p.scale2 : -INFINITY;
        mx = fmaxf(mx, sc[a][b]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[a], mx);
      float alpha = 1.f, rs = 0.f;
      if (mn == -INFINITY) {  // no valid key so far for this query
#pragma unroll
        for (int b = 0; b < T; ++b) sc[a][b] = 0.f;
      } else {
        alpha = exp2_fast(m[a] - mn);
#pragma unroll
        for (int b = 0; b < T; ++b) {
          sc[a][b] = valid[b] ? exp2_fast(sc[a][b] - mn) : 0.f;
          rs += sc[a][b];
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[a] = l[a] * alpha + rs;
      m[a] = mn;
      if (!st.first) {  // the accumulator is still 0 on a unit's first tile
#pragma unroll
        for (int u = 0; u < kCpl; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][u][e] *= alpha;
      }
    }
    // P[key][query group][query slot]: both feature halves hold the same
    // values and write them to the same addresses
#pragma unroll
    for (int b = 0; b < T; ++b) {
      float* slot = pbuf + ((kg * T + b) * 4 + qg) * kPSlot;
      if constexpr (TQ >= 2) *reinterpret_cast<float2*>(slot) = make_float2(sc[0][b], sc[1][b]);
      if constexpr (TQ == 3) slot[2] = sc[2][b];
      if constexpr (TQ == 1) slot[0] = sc[0][b];
    }
    __syncwarp();

    // P v over the valid keys, kPV a pass (a warp-uniform loop; masked keys
    // skipped)
    {
      const auto p_of = [&](int j, float (&pj)[TQ]) {
        const float* slot = pbuf + (j * 4 + qg) * kPSlot;
        if constexpr (TQ >= 2) {
          const float2 pa = *reinterpret_cast<const float2*>(slot);
          pj[0] = pa.x;
          pj[1] = pa.y;
        }
        if constexpr (TQ == 3) pj[2] = slot[2];
        if constexpr (TQ == 1) pj[0] = slot[0];
      };
      const int vrow0 = p.qrows + p.krows;
      const int vnch = kSplit ? (st.wv + 3) >> 2 : p.nch;
      unsigned bits = vbits;
      constexpr int kPV = 4;  // valid keys a pass, their loads in flight together
      while (bits) {
        int js[kPV];
        bool on[kPV];
#pragma unroll
        for (int t = 0; t < kPV; ++t) {
          on[t] = bits != 0;
          js[t] = on[t] ? __ffs(bits) - 1 : js[0];
          if (on[t]) bits &= bits - 1;
        }
        float pk[kPV][TQ];
#pragma unroll
        for (int t = 0; t < kPV; ++t) p_of(js[t], pk[t]);
#pragma unroll
        for (int u = 0; u < kCpl; ++u) {
          const int c = fg + 8 * u;
          if (u < p.cpl && c < vnch) {
            float4 vk[kPV];
#pragma unroll
            for (int t = 0; t < kPV; ++t) {
              const int r = vrow0 + js[t];
              vk[t] = load4<kMode>(stage + r * p.Wp + swz<kMode, T>(r, c));
            }
#pragma unroll
            for (int t = 0; t < kPV; ++t) {
              if (on[t]) {
#pragma unroll
                for (int a = 0; a < TQ; ++a) {
                  acc[a][u][0] = fmaf(pk[t][a], vk[t].x, acc[a][u][0]);
                  acc[a][u][1] = fmaf(pk[t][a], vk[t].y, acc[a][u][1]);
                  acc[a][u][2] = fmaf(pk[t][a], vk[t].z, acc[a][u][2]);
                  acc[a][u][3] = fmaf(pk[t][a], vk[t].w, acc[a][u][3]);
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();  // P read before the next step writes it
    if (!st.last) continue;

    // out = acc / l for this lane's queries and chunks; 0 with no valid key
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const int i = kWarps * (qg * TQ + a) + w;
      if (i < st.qn) {
        const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
        float* orow = p.out + (static_cast<size_t>(st.row) * p.A + st.q0 + i) * p.D +
                      static_cast<size_t>(st.head) * p.hd + st.oc * p.cw;
        const int vnch = kSplit ? (st.wv + 3) >> 2 : p.nch;
#pragma unroll
        for (int u = 0; u < kCpl; ++u) {
          const int c = fg + 8 * u;
          if (u < p.cpl && c < vnch) {
            const float o0 = acc[a][u][0] * inv, o1 = acc[a][u][1] * inv,
                        o2 = acc[a][u][2] * inv, o3 = acc[a][u][3] * inv;
            if (p.hdp == p.hd) {  // 16-byte stores; out is 16-byte aligned
              *reinterpret_cast<float4*>(orow + 4 * c) = make_float4(o0, o1, o2, o3);
            } else {
              const float o[4] = {o0, o1, o2, o3};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (4 * c + e < st.wv) orow[4 * c + e] = o[e];
            }
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <int kMode, int T, bool kSplit = false>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = packed_masked_attention_kernel<kMode, T, kSplit>;
  // set once per device: the largest dynamic shared memory any call asks for
  static bool attr_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  // blocks per SM for the last shared-memory size seen on each device
  static size_t occ_smem[kMaxDevices] = {};
  static int occ_blocks[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (occ_smem[dev] != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    occ_smem[dev] = smem;
    occ_blocks[dev] = blocks;
  }
  const int resident = sms[dev] * occ_blocks[dev];
  const int grid = p.units < resident ? p.units : resident;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// T for a head dim of cpl accumulator chunks a lane (see the top)
static_assert(max_chunks(tile_queries(5)) >= 2 && max_chunks(tile_queries(4)) >= 4 &&
                  max_chunks(tile_queries(2)) >= 8,
              "T = 5 / 4 / 2 must keep 2 / 4 / 8 chunks a lane in registers");

template <int kMode>
cudaError_t launch_tile(int T, const Params& p, size_t smem, cudaStream_t s) {
  if (p.ncc > 1) return launch<kMode, 2, true>(p, smem, s);
  switch (T) {
    case 2: return launch<kMode, 2>(p, smem, s);
    case 4: return launch<kMode, 4>(p, smem, s);
    default: return launch<kMode, 5>(p, smem, s);
  }
}

}  // namespace

// q, k, v (rows, A, D), f32 (bf16 == 0) or bf16 (bf16 != 0); mask (rows, A)
// bytes, nonzero = valid key; out (rows, A, D) f32, 16-byte aligned. Takes
// A >= 1 and D a multiple of num_heads. Returns a cudaError_t (0 on
// success); nothing is launched for bad sizes.
extern "C" int packed_masked_attention_forward(const void* q, const void* k, const void* v,
                                               const void* mask, void* out, int rows, int A,
                                               int D, int num_heads, int bf16, void* stream) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (rows < 0 || A < 1 || num_heads < 1 || D < 1 || D % num_heads != 0 || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int hd = D / num_heads;
  const bool vec = aligned(q) && aligned(k) && aligned(v);
  const int mode = bf16 ? (vec && hd % 8 == 0 ? kBf16Vec : kPlain)
                        : (vec && hd % 4 == 0 ? kF32Vec : kPlain);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const unsigned char*>(mask);
  p.out = static_cast<float*>(out);
  p.A = A;
  p.D = D;
  p.hd = hd;
  p.H = num_heads;
  p.bf16 = bf16 != 0;
  p.hdp = (hd + 3) / 4 * 4;
  p.cw = p.hdp <= kMaxChunkDim ? p.hdp : kMaxChunkDim;
  p.ncc = (hd + p.cw - 1) / p.cw;
  p.nch = p.hdp / 4;
  p.cpl = (p.cw / 4 + 7) / 8;
  const int T = p.cpl <= 2 ? 5 : (p.cpl <= 4 ? 4 : 2);
  p.ktile = 4 * T;
  p.qtile = 4 * kWarps * tile_queries(T);
  p.qrows = p.qtile < A ? p.qtile : A;
  p.krows = p.ktile < A ? p.ktile : A;
  p.nqt = (A + p.qtile - 1) / p.qtile;
  p.nkt = (A + p.ktile - 1) / p.ktile;
  const long long units = static_cast<long long>(rows) * num_heads * p.nqt * p.ncc;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  // rows of whole 128-byte lines, so the swizzle stays inside a row
  const int esize = mode == kBf16Vec ? 2 : 4;
  const int per_line = 128 / esize;
  p.Wp = (p.cw + per_line - 1) / per_line * per_line;
  p.stage_bytes = (p.qrows + 2 * p.krows) * p.Wp * esize;
  p.scale2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  const size_t smem = static_cast<size_t>(kStages) * p.stage_bytes +
                      sizeof(float) * kWarps * p.ktile * 4 * kPSlot;
  if (smem > static_cast<size_t>(kSmemBudget)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err;
  if (mode == kBf16Vec)
    err = launch_tile<kBf16Vec>(T, p, smem, s);
  else if (mode == kPlain)
    err = launch_tile<kPlain>(T, p, smem, s);
  else
    err = launch_tile<kF32Vec>(T, p, smem, s);
  return static_cast<int>(err);
}
