// The ORCA solve of the env step for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package's ORCA (env/orca.py,
// `orca_velocity_batch`) is plain XLA. The port ran it as whole-batch tensor
// ops (env/orca.py: `orca_lines`, `_lp2`, `_lp3`), which loop in Python
// over the line slots: 1,175 device launches an env step at 64 envs x 20
// humans (21 lines an ego) and 2,466 at 256 envs x 50, plus one blocking
// read a step (`nonzero`, to find the egos whose LP2 failed). Each launch
// did ~2 us of device work and cost the host ~10-14 us to launch. This
// kernel does the whole solve in one launch, with no host round trip.
//
// For each ego (E of them, N neighbour slots each) it computes
//   * the ORCA half-plane of every valid neighbour (RVO2's computeNewVelocity,
//     with the neighbor_dist cut of its KdTree query), into shared memory;
//   * RVO2's linearProgram2 over those lines in their order, each
//     linearProgram1 bounded by the earlier valid lines;
//   * only where that failed, RVO2's linearProgram3 from the failing line
//     on, bounded at the outer line index (PARITY.md, deviation 11).
//
// What bounds it: neither bytes (~30 B an ego-neighbour, read once) nor
// flops (a few thousand an ego) but latency: the LP is a chain of dependent
// scalar steps, each line's step depending on the result of the ones
// before. The design:
//   * one warp an ego, kWarps egos a block (320 blocks at 1,280 egos, 3,200
//     at 12,800, over the 132 SMs), the ego's lines in the warp's slice of
//     shared memory; the warp never waits on another;
//   * each step's independent work across the lanes: the lines (a lane a
//     neighbour), and each linearProgram1's bounds over the earlier lines
//     (a lane a constraint, then warp shuffles for the min and max and a
//     vote for "any"; min and max are exact, so their order does not
//     matter);
//   * the sequential scan tests 32 lines at once against the current result
//     and takes the first that needs work (a ballot); the lines after it are
//     tested again with the new result, so the choices are those of the
//     one-line-at-a-time loop;
//   * LP3 lazily: its inner linearProgram2 is solved only for the outer lines
//     that need it (the plain version solves it for all and selects), and the
//     projected lines of outer line i are computed from lines i and j when
//     read, never stored, so the shared memory is that of the lines alone
//     (N = 300 fits).
// The arithmetic is the plain version's, bit for bit: every product, sum,
// quotient and square root is rounded on its own, in the plain version's
// order (the _rn intrinsics, so nothing is contracted into an FMA, whatever
// the compiler's flags), the host's scalars are rounded to the working type
// as PyTorch rounds them, and min and max propagate NaN as torch.minimum and
// amin do. float32 and float64, as the caller's tensors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;         // egos a block, a warp each
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

template <typename T>
struct V2 {
  T x, y;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// torch.minimum / amin and torch.maximum / amax: NaN wins
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : fmin(a, b));
}
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : fmax(a, b));
}
// Tensor.clamp_min: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T a, T lo) {
  return isnan(a) ? a : fmax(a, lo);
}

// _dot(a, b) and _det(a, b) of env/orca.py
template <typename T>
__device__ __forceinline__ T dot(V2<T> a, V2<T> b) {
  return add(mul(a.x, b.x), mul(a.y, b.y));
}
template <typename T>
__device__ __forceinline__ T det(V2<T> a, V2<T> b) {
  return sub(mul(a.x, b.y), mul(a.y, b.x));
}
template <typename T>
__device__ __forceinline__ V2<T> minus(V2<T> a, V2<T> b) {
  return {sub(a.x, b.x), sub(a.y, b.y)};
}
// p + t d, as p + t[..., None] * d
template <typename T>
__device__ __forceinline__ V2<T> along(V2<T> p, T t, V2<T> d) {
  return {add(p.x, mul(t, d.x)), add(p.y, mul(t, d.y))};
}

// The plain version's Python scalars, rounded to T as PyTorch rounds them
template <typename T>
struct Consts {
  T eps = static_cast<T>(1e-5);   // RVO_EPSILON (_EPS)
  T safe = static_cast<T>(1e-9);  // _SAFE
};

// The ego's ORCA lines, in the warp's slice of shared memory
template <typename T>
struct OwnLines {
  const V2<T>* d;
  const V2<T>* p;
  const unsigned char* valid;
  __device__ __forceinline__ bool get(int j, V2<T>& dj, V2<T>& pj) const {
    dj = d[j];
    pj = p[j];
    return valid[j] != 0;
  }
};

// LP3's line j projected on the outer line i (j < i), computed when read
// (the (E, n, n) tensors of _lp3, one entry)
template <typename T>
struct ProjectedLines {
  OwnLines<T> lines;
  V2<T> di, pi;
  __device__ __forceinline__ bool get(int j, V2<T>& dir, V2<T>& point) const {
    const Consts<T> c;
    V2<T> dj, pj;
    const bool valid = lines.get(j, dj, pj);
    const T determinant = det(di, dj);
    const bool parallel = fabs(determinant) <= c.eps;
    const bool same_dir = dot(di, dj) > T(0);
    if (parallel) {
      point = {mul(T(0.5), add(pi.x, pj.x)), mul(T(0.5), add(pi.y, pj.y))};
    } else {
      point = along(pi, quo(det(dj, minus(pi, pj)), determinant), di);
    }
    const V2<T> diff = minus(dj, di);
    const T len = clamp_min(root(dot(diff, diff)), c.safe);
    dir = {quo(diff.x, len), quo(diff.y, len)};
    // parallel lines pointing the same way impose no projected constraint
    return valid && !(parallel && same_dir);
  }
};

// RVO2 linearProgram1 on line i (di, pi), bounded by the valid lines j < i
// (_lp1_all, one line): the candidate and whether it is feasible. Every
// lane of the warp calls it and gets the same answer.
template <typename T, bool kDirOpt, class Lines>
__device__ bool lp1(const Lines& lines, int i, V2<T> di, V2<T> pi, T radius, V2<T> opt,
                    V2<T>& cand, int lane) {
  const Consts<T> c;
  const T dt = dot(pi, di);
  const T disc = sub(add(mul(dt, dt), mul(radius, radius)), dot(pi, pi));
  bool feasible = disc >= T(0);
  const T sqrt_disc = root(clamp_min(disc, T(0)));
  T t_left = sub(-dt, sqrt_disc);
  T t_right = add(-dt, sqrt_disc);

  T upper = INFINITY, lower = -INFINITY;
  bool violated = false;
  for (int j = lane; j < i; j += 32) {
    V2<T> dj, pj;
    if (!lines.get(j, dj, pj)) continue;
    const T denom = det(di, dj);
    const T numer = det(dj, minus(pi, pj));
    if (fabs(denom) <= c.eps) {
      // a parallel constraint that line i entirely violates
      violated |= numer < T(0);
      continue;
    }
    const T t = quo(numer, denom);
    if (denom >= T(0)) {
      upper = min_nan(upper, t);
    } else if (denom < T(0)) {
      lower = max_nan(lower, t);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    upper = min_nan(upper, __shfl_xor_sync(kFull, upper, o));
    lower = max_nan(lower, __shfl_xor_sync(kFull, lower, o));
  }
  violated = __any_sync(kFull, violated);
  t_right = min_nan(t_right, upper);
  t_left = max_nan(t_left, lower);
  feasible = feasible && !violated && t_left <= t_right;

  T t_opt;
  if (kDirOpt) {
    t_opt = dot(opt, di) > T(0) ? t_right : t_left;
  } else {
    t_opt = min_nan(max_nan(dot(di, minus(opt, pi)), t_left), t_right);
  }
  cand = along(pi, t_opt, di);
  return feasible;
}

// RVO2 linearProgram2 over n lines (_lp2): the index of the line where it
// failed, or n, with the result so far in `result`.
template <typename T, bool kDirOpt, class Lines>
__device__ int lp2(const Lines& lines, int n, T radius, V2<T> opt, V2<T>& result, int lane) {
  if (kDirOpt) {
    result = {mul(opt.x, radius), mul(opt.y, radius)};
  } else {
    const T speed = root(dot(opt, opt));
    if (speed > radius) {
      const T s = clamp_min(speed, Consts<T>().safe);
      result = {mul(quo(opt.x, s), radius), mul(quo(opt.y, s), radius)};
    } else {
      result = opt;
    }
  }
  for (int base = 0; base < n;) {
    // the first of the next 32 lines that the result violates
    const int i = base + lane;
    bool need = false;
    if (i < n) {
      V2<T> d, p;
      if (lines.get(i, d, p)) need = det(d, minus(p, result)) > T(0);
    }
    const unsigned hit = __ballot_sync(kFull, need);
    if (!hit) {
      base += 32;
      continue;
    }
    const int k = base + __ffs(hit) - 1;
    V2<T> dk, pk, cand;
    lines.get(k, dk, pk);
    if (!lp1<T, kDirOpt>(lines, k, dk, pk, radius, opt, cand, lane)) return k;
    result = cand;
    base = k + 1;
  }
  return n;
}

// RVO2 linearProgram3 from line `begin` on (_lp3): minimise the largest
// violation of the valid lines.
template <typename T>
__device__ void lp3(const OwnLines<T>& lines, int n, int begin, T radius, V2<T>& result,
                    int lane) {
  T distance = T(0);
  for (int base = begin; base < n;) {
    const int i = base + lane;
    bool need = false;
    if (i < n) {
      V2<T> d, p;
      if (lines.get(i, d, p)) need = det(d, minus(p, result)) > distance;
    }
    const unsigned hit = __ballot_sync(kFull, need);
    if (!hit) {
      base += 32;
      continue;
    }
    const int k = base + __ffs(hit) - 1;
    ProjectedLines<T> projected{lines, {}, {}};
    lines.get(k, projected.di, projected.pi);
    const V2<T> perp = {-projected.di.y, projected.di.x};
    V2<T> inner;
    if (lp2<T, true>(projected, k, radius, perp, inner, lane) == k) result = inner;
    distance = det(projected.di, minus(projected.pi, result));
    base = k + 1;
  }
}

template <typename T>
struct Params {
  const T* ego_pos;         // (E, 2)
  const T* ego_vel;         // (E, 2)
  const T* ego_radius;      // (E,)
  const T* ego_max_speed;   // (E,)
  const T* pref_vel;        // (E, 2)
  const T* nbr_pos;         // (E, N, 2)
  const T* nbr_vel;         // (E, N, 2)
  const T* nbr_radius;      // (E, N)
  const unsigned char* nbr_mask;  // (E, N) bool
  const T* neighbor_dist;   // (E,)
  T* out;                   // (E, 2)
  int* lp3_egos;            // egos that ran LP3 are added here, or null
  int E, N;
  size_t warp_bytes;        // a warp's slice of shared memory
  T inv_th, inv_dt;         // 1 / time_horizon, 1 / time_step
};

// orca_lines for neighbour j of ego e: (direction, point, valid)
template <typename T>
__device__ bool orca_line(const Params<T>& p, int64_t e, int j, V2<T>& direction,
                          V2<T>& point) {
  const Consts<T> c;
  const int64_t en = e * p.N + j;
  const V2<T> ego_pos = {p.ego_pos[2 * e], p.ego_pos[2 * e + 1]};
  const V2<T> ego_vel = {p.ego_vel[2 * e], p.ego_vel[2 * e + 1]};
  const V2<T> nbr_pos = {p.nbr_pos[2 * en], p.nbr_pos[2 * en + 1]};
  const V2<T> nbr_vel = {p.nbr_vel[2 * en], p.nbr_vel[2 * en + 1]};
  const T nd = p.neighbor_dist[e];

  const V2<T> rel_pos = minus(nbr_pos, ego_pos);
  const V2<T> rel_vel = minus(ego_vel, nbr_vel);
  const T dist_sq = dot(rel_pos, rel_pos);
  const T comb_r = add(p.ego_radius[e], p.nbr_radius[en]);
  const T comb_r_sq = mul(comb_r, comb_r);
  const bool valid = p.nbr_mask[en] != 0 && dist_sq < mul(nd, nd);

  V2<T> u;
  if (dist_sq > comb_r_sq) {
    // no collision: project on the cut-off circle or on a leg
    const V2<T> w = {sub(rel_vel.x, mul(p.inv_th, rel_pos.x)),
                     sub(rel_vel.y, mul(p.inv_th, rel_pos.y))};
    const T w_len_sq = dot(w, w);
    const T dot1 = dot(w, rel_pos);
    if (dot1 < T(0) && mul(dot1, dot1) > mul(comb_r_sq, w_len_sq)) {
      const T w_len = root(clamp_min(w_len_sq, c.safe));
      const V2<T> unit_w = {quo(w.x, w_len), quo(w.y, w_len)};
      direction = {unit_w.y, -unit_w.x};
      const T s = sub(mul(comb_r, p.inv_th), w_len);
      u = {mul(s, unit_w.x), mul(s, unit_w.y)};
    } else {
      const T leg = root(clamp_min(sub(dist_sq, comb_r_sq), T(0)));
      const T rx = rel_pos.x, ry = rel_pos.y;
      V2<T> dl;
      if (det(rel_pos, w) > T(0)) {   // left leg
        dl = {sub(mul(rx, leg), mul(ry, comb_r)), add(mul(rx, comb_r), mul(ry, leg))};
      } else {                        // minus the right leg
        dl = {-add(mul(rx, leg), mul(ry, comb_r)), -add(mul(-rx, comb_r), mul(ry, leg))};
      }
      const T scale = clamp_min(dist_sq, c.safe);
      direction = {quo(dl.x, scale), quo(dl.y, scale)};
      const T dot2 = dot(rel_vel, direction);
      u = {sub(mul(dot2, direction.x), rel_vel.x), sub(mul(dot2, direction.y), rel_vel.y)};
    }
  } else {
    // collision: leave within the time step
    const V2<T> w = {sub(rel_vel.x, mul(p.inv_dt, rel_pos.x)),
                     sub(rel_vel.y, mul(p.inv_dt, rel_pos.y))};
    const T w_len = clamp_min(root(dot(w, w)), c.safe);
    const V2<T> unit_w = {quo(w.x, w_len), quo(w.y, w_len)};
    direction = {unit_w.y, -unit_w.x};
    const T s = sub(mul(comb_r, p.inv_dt), w_len);
    u = {mul(s, unit_w.x), mul(s, unit_w.y)};
  }
  // reciprocity: share the avoidance 50/50
  point = {add(ego_vel.x, mul(T(0.5), u.x)), add(ego_vel.y, mul(T(0.5), u.y))};
  return valid;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) orca_solve_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (e >= p.E) return;   // the whole warp: nothing below syncs the block
  const int n = p.N;
  unsigned char* base = smem + warp * p.warp_bytes;
  V2<T>* d = reinterpret_cast<V2<T>*>(base);
  V2<T>* pt = d + n;
  unsigned char* valid = reinterpret_cast<unsigned char*>(pt + n);
  for (int j = lane; j < n; j += 32) valid[j] = orca_line(p, e, j, d[j], pt[j]);
  __syncwarp();

  const OwnLines<T> lines{d, pt, valid};
  const V2<T> pref = {p.pref_vel[2 * e], p.pref_vel[2 * e + 1]};
  const T max_speed = p.ego_max_speed[e];
  V2<T> result;
  const int fail = lp2<T, false>(lines, n, max_speed, pref, result, lane);
  if (fail < n) {
    if (lane == 0 && p.lp3_egos) atomicAdd(p.lp3_egos, 1);
    lp3(lines, n, fail, max_speed, result, lane);
  }
  if (lane == 0) {
    p.out[2 * e] = result.x;
    p.out[2 * e + 1] = result.y;
  }
}

template <typename T>
int launch(Params<T> p, cudaStream_t stream) {
  p.warp_bytes = (2 * p.N * sizeof(V2<T>) + p.N + 15) / 16 * 16;
  int warps = kWarps;
  while (warps > 1 && warps * p.warp_bytes > kSmemDefault) --warps;
  const size_t smem = warps * p.warp_bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        orca_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((p.E + warps - 1) / warps);
  orca_solve_kernel<T><<<blocks, 32 * warps, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Params<T> params(const void* ego_pos, const void* ego_vel, const void* ego_radius,
                 const void* ego_max_speed, const void* pref_vel, const void* nbr_pos,
                 const void* nbr_vel, const void* nbr_radius, const void* nbr_mask,
                 const void* neighbor_dist, void* out, void* lp3_egos, int E, int N,
                 double inv_th, double inv_dt) {
  Params<T> p;
  p.ego_pos = static_cast<const T*>(ego_pos);
  p.ego_vel = static_cast<const T*>(ego_vel);
  p.ego_radius = static_cast<const T*>(ego_radius);
  p.ego_max_speed = static_cast<const T*>(ego_max_speed);
  p.pref_vel = static_cast<const T*>(pref_vel);
  p.nbr_pos = static_cast<const T*>(nbr_pos);
  p.nbr_vel = static_cast<const T*>(nbr_vel);
  p.nbr_radius = static_cast<const T*>(nbr_radius);
  p.nbr_mask = static_cast<const unsigned char*>(nbr_mask);
  p.neighbor_dist = static_cast<const T*>(neighbor_dist);
  p.out = static_cast<T*>(out);
  p.lp3_egos = static_cast<int*>(lp3_egos);
  p.E = E;
  p.N = N;
  p.warp_bytes = 0;
  p.inv_th = static_cast<T>(inv_th);
  p.inv_dt = static_cast<T>(inv_dt);
  return p;
}

}  // namespace

// New ORCA velocities `out` (E, 2) for E egos against N neighbour slots
// each, as env/orca.py's orca_velocity_batch. All tensors contiguous, of one
// floating type (f64 != 0: float64, else float32) but the bool mask.
// `lp3_egos` (an int32 on the device, or null) gains the number of egos
// whose LP2 failed. inv_th and inv_dt are 1 / time_horizon and
// 1 / time_step in double, rounded to the working type here. Returns the
// launch's cudaError (0 on success).
extern "C" int orca_solve(const void* ego_pos, const void* ego_vel, const void* ego_radius,
                          const void* ego_max_speed, const void* pref_vel, const void* nbr_pos,
                          const void* nbr_vel, const void* nbr_radius, const void* nbr_mask,
                          const void* neighbor_dist, void* out, void* lp3_egos, int E, int N,
                          double inv_th, double inv_dt, int f64, void* stream) {
  if (E < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (f64) {
    return launch(params<double>(ego_pos, ego_vel, ego_radius, ego_max_speed, pref_vel, nbr_pos,
                                 nbr_vel, nbr_radius, nbr_mask, neighbor_dist, out, lp3_egos, E,
                                 N, inv_th, inv_dt),
                  s);
  }
  return launch(params<float>(ego_pos, ego_vel, ego_radius, ego_max_speed, pref_vel, nbr_pos,
                              nbr_vel, nbr_radius, nbr_mask, neighbor_dist, out, lp3_egos, E, N,
                              inv_th, inv_dt),
                s);
}
