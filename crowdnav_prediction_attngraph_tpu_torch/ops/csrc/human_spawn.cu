// The env's rejection-sampling spawn passes for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package's spawn (env/spawn.py,
// `batched_circle_spawn` and `batched_goal_resample`) is plain XLA. The
// port ran them as whole-batch tensor ops (env/spawn.py:
// `reference_circle_spawn`, `reference_goal_resample`): SPAWN_ROUNDS = 10
// proposal and rejection rounds of ~45 small ops, or GOAL_ROUNDS = 8 of
// ~30, each op a launch over a (B, A) or (B, A, A) tensor of a few KB. The
// env step ran one or two such passes on nearly every step (the humans'
// end-goal respawn, the every-5 s goal change and human count change) and
// the auto-reset one more, each behind a blocking host read. This kernel
// does a whole pass in one launch, with no host round trip.
//
// Two entries, one for each plain function:
//   * circle_spawn: every slot in `need` gets a position on the circle
//     ring; each round proposes for the slots still unplaced and rejects a
//     proposal near the robot's position or goal, near a placed human or
//     its goal, or near a lower-indexed slot's proposal of the same round
//     (or its mirror, the goal that slot would take). A slot unplaced after
//     the last round keeps its first (fallback) proposal. The goal is minus
//     the position.
//   * goal_resample: every slot in `need` gets a new goal on the ring
//     (noise scaled by its preferred speed), rejected near the robot or near
//     any other active human's position or goal; the first proposal is the
//     fallback.
//
// What bounds it: latency. A pass reads a few KB an env and does a few
// thousand flops a slot; its rounds depend on each other. The design:
//   * one block an env, a thread a slot (slots strided over the block's
//     threads past 256), the env's positions, goals, radii and the round's
//     proposals in shared memory;
//   * circle_spawn: each round, the slots' proposals go to shared memory,
//     a barrier, then each pending slot tests its proposal against every
//     slot (the "any" over j is an OR, so its order is free), a barrier,
//     and the accepted proposals are placed at the next round's start. A
//     round in which no slot is pending ends the loop: the rounds after it
//     change nothing;
//   * goal_resample: the obstacles do not change between rounds, so each
//     slot runs its rounds alone and stops at its first accepted proposal.
// The arithmetic is the plain version's, bit for bit: the proposals through
// the same cosf / sinf as PyTorch's CUDA cos and sin (no fast math), every
// product, sum and square root rounded on its own in the plain version's
// order (the _rn intrinsics, so nothing is contracted into an FMA), each
// torch.linalg.norm over a 2-vector as PyTorch's CUDA reduction computes
// it (each square rounded, then their sum, then the square root), and the
// host's scalars rounded to float as PyTorch rounds them. float32 only, as
// the env's state.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;
// the plain version's Python scalars, rounded to float as PyTorch rounds
// them against a float32 tensor
constexpr float kTwoPi = static_cast<float>(6.283185307179586);  // TWO_PI
constexpr float kSpawnNoiseScale = 2.0f;                          // _ring's
constexpr float kSpawnNoiseShift = 0.0f;
constexpr float kGoalNoiseShift = -0.5f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.linalg.norm(v, dim=-1) of a 2-vector on CUDA: the reduction squares
// each entry in its own thread and adds the two
__device__ __forceinline__ float norm(float x, float y) {
  return __fsqrt_rn(add(mul(x, x), mul(y, y)));
}
__device__ __forceinline__ float dist(float2 a, float2 b) {
  return norm(sub(a.x, b.x), sub(a.y, b.y));
}

// _ring: circle_radius (cos, sin)(2 pi u_angle) + (u_noise + shift) * scale
// for slot i of draw chunk c (a chunk: A angles, then A (x, y) noise pairs)
__device__ __forceinline__ float2 proposal(const float* row, int A, int c, int i,
                                           float circle_radius, float shift, float scale) {
  const float* chunk = row + static_cast<int64_t>(c) * 3 * A;
  const float angle = mul(chunk[i], kTwoPi);
  const float nx = mul(add(chunk[A + 2 * i], shift), scale);
  const float ny = mul(add(chunk[A + 2 * i + 1], shift), scale);
  return make_float2(add(mul(circle_radius, cosf(angle)), nx),
                     add(mul(circle_radius, sinf(angle)), ny));
}

__device__ __forceinline__ float2 load2(const float* p, int64_t i) {
  return make_float2(p[2 * i], p[2 * i + 1]);
}
__device__ __forceinline__ void store2(float* p, int64_t i, float2 v) {
  p[2 * i] = v.x;
  p[2 * i + 1] = v.y;
}

// The slots in `need` of this thread's share, added to `slots` once a warp
__device__ __forceinline__ void count_slots(int* slots, int mine) {
  if (!slots) return;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(slots, mine);
}

struct Params {
  const float* u;                    // (B, >= draws), rows u_stride apart
  int64_t u_stride;
  const unsigned char* need;         // (B, A) bool
  const float* self_radius;          // (B, A)
  const float* v_pref;               // (B, A), goal_resample only
  const float* robot_pos;            // (B, 2)
  const float* robot_goal;           // (B, 2)
  const float* robot_radius;         // (B,)
  const float* humans_pos;           // (B, A, 2)
  const float* humans_goal;          // (B, A, 2)
  const float* humans_radius;        // (B, A)
  const unsigned char* mask;         // (B, A) bool: placed, or active
  float* pos_out;                    // (B, A, 2), circle_spawn only
  float* goal_out;                   // (B, A, 2)
  int* slots;                        // gains the slots in need, or null
  int A, rounds;
  float circle_radius, discomfort_dist, robot_min_dist;
  int has_robot_min_dist;
};

// batched_circle_spawn for env blockIdx.x
__global__ void __launch_bounds__(kMaxThreads) circle_spawn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A;
  const int64_t b = blockIdx.x;
  float2* pos = reinterpret_cast<float2*>(smem);   // placed or fallback
  float2* cand = pos + A;                           // the round's candidates
  float2* cur_goal = cand + A;                      // obstacles' goals
  float* sr = reinterpret_cast<float*>(cur_goal + A);
  float* hr = sr + A;
  unsigned char* need = reinterpret_cast<unsigned char*>(hr + A);
  unsigned char* placed = need + A;
  unsigned char* pending = placed + A;
  unsigned char* accept = pending + A;

  const float* row = p.u + b * p.u_stride;
  const float2 rpos = load2(p.robot_pos, b), rgoal = load2(p.robot_goal, b);
  const float rr = p.robot_radius[b], dd = p.discomfort_dist;
  int mine = 0;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    const int64_t bi = b * A + i;
    const bool n = p.need[bi] != 0;
    sr[i] = p.self_radius[bi];
    hr[i] = p.humans_radius[bi];
    need[i] = n;
    placed[i] = p.mask[bi] != 0 && !n;
    accept[i] = 0;
    pos[i] = n ? proposal(row, A, 0, i, p.circle_radius, kSpawnNoiseShift, kSpawnNoiseScale)
               : load2(p.humans_pos, bi);
    mine += n;
  }
  count_slots(p.slots, mine);

  for (int r = 0; r < p.rounds; ++r) {
    // each thread's own slots: place last round's accepted candidates,
    // then this round's candidates and the obstacles' goals
    bool any = false;
    for (int i = threadIdx.x; i < A; i += blockDim.x) {
      if (accept[i]) {
        pos[i] = cand[i];
        placed[i] = 1;
        accept[i] = 0;
      }
      const bool pend = need[i] && !placed[i];
      pending[i] = pend;
      any |= pend;
      if (pend) {
        cand[i] = proposal(row, A, r + 1, i, p.circle_radius, kSpawnNoiseShift,
                           kSpawnNoiseScale);
      }
      cur_goal[i] = (need[i] && placed[i]) ? make_float2(-pos[i].x, -pos[i].y)
                                           : load2(p.humans_goal, b * A + i);
    }
    if (!__syncthreads_or(any)) break;
    for (int i = threadIdx.x; i < A; i += blockDim.x) {
      if (!pending[i]) continue;
      const float2 c = cand[i];
      const float sri = sr[i];
      const float md_rob = p.has_robot_min_dist ? p.robot_min_dist
                                                : add(add(sri, rr), dd);
      bool bad = dist(c, rpos) < md_rob || dist(c, rgoal) < md_rob;
      for (int j = 0; j < A && !bad; ++j) {
        if (placed[j]) {
          // a placed human (never pending): its position and goal
          const float md = add(add(sri, hr[j]), dd);
          bad = dist(c, pos[j]) < md || dist(c, cur_goal[j]) < md;
        } else if (j < i && pending[j]) {
          // this round's lower-indexed candidate and its mirror
          const float md = add(add(sri, sr[j]), dd);
          const float2 o = cand[j];
          bad = dist(c, o) < md || norm(add(c.x, o.x), add(c.y, o.y)) < md;
        }
      }
      accept[i] = !bad;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    const int64_t bi = b * A + i;
    const float2 at = accept[i] ? cand[i] : pos[i];
    if (need[i]) {
      store2(p.pos_out, bi, at);
      store2(p.goal_out, bi, make_float2(-at.x, -at.y));
    } else {
      store2(p.pos_out, bi, load2(p.humans_pos, bi));
      store2(p.goal_out, bi, load2(p.humans_goal, bi));
    }
  }
}

// batched_goal_resample for env blockIdx.x
__global__ void __launch_bounds__(kMaxThreads) goal_resample_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A;
  const int64_t b = blockIdx.x;
  float2* hpos = reinterpret_cast<float2*>(smem);
  float2* hgoal = hpos + A;
  float* hr = reinterpret_cast<float*>(hgoal + A);
  unsigned char* active = reinterpret_cast<unsigned char*>(hr + A);

  int mine = 0;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    const int64_t bi = b * A + i;
    hpos[i] = load2(p.humans_pos, bi);
    hgoal[i] = load2(p.humans_goal, bi);
    hr[i] = p.humans_radius[bi];
    active[i] = p.mask[bi];
    mine += p.need[bi] != 0;
  }
  count_slots(p.slots, mine);
  __syncthreads();

  const float* row = p.u + b * p.u_stride;
  const float2 rpos = load2(p.robot_pos, b), rgoal = load2(p.robot_goal, b);
  const float rr = p.robot_radius[b], dd = p.discomfort_dist;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    const int64_t bi = b * A + i;
    if (!p.need[bi]) {
      store2(p.goal_out, bi, hgoal[i]);
      continue;
    }
    const float vp = p.v_pref[bi];
    const float v = vp == 0.0f ? 1.0f : vp;
    const float sri = p.self_radius[bi];
    const float md_rob = add(add(sri, rr), dd);
    float2 goal = proposal(row, A, 0, i, p.circle_radius, kGoalNoiseShift, v);
    for (int r = 0; r < p.rounds; ++r) {
      const float2 c = proposal(row, A, r + 1, i, p.circle_radius, kGoalNoiseShift, v);
      bool bad = dist(c, rpos) < md_rob || dist(c, rgoal) < md_rob;
      for (int j = 0; j < A && !bad; ++j) {
        if (!active[j] || j == i) continue;
        const float md = add(add(sri, hr[j]), dd);
        bad = dist(c, hpos[j]) < md || dist(c, hgoal[j]) < md;
      }
      if (!bad) {
        goal = c;
        break;
      }
    }
    store2(p.goal_out, bi, goal);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int B, size_t slot_bytes, void* stream) {
  if (B < 0 || p.A < 0 || p.rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || p.A == 0) return 0;
  const size_t smem = (slot_bytes * p.A + 15) / 16 * 16;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = p.A >= kMaxThreads ? kMaxThreads : (p.A + 31) / 32 * 32;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// env/spawn.py's batched_circle_spawn: new positions `pos_out` and goals
// `goal_out` (B, A, 2) for the slots in `need`, the others' copied from
// humans_pos / humans_goal. All tensors contiguous float32 but the bool
// masks and `u`, whose rows are u_stride floats apart. `slots` (an int32 on
// the device, or null) gains the number of slots in need. The doubles are
// the plain version's Python floats, rounded to float here; robot_min_dist
// is read when has_robot_min_dist != 0. Returns the launch's cudaError.
extern "C" int circle_spawn(const void* u, int64_t u_stride, const void* need,
                            const void* self_radius, const void* robot_pos,
                            const void* robot_goal, const void* robot_radius,
                            const void* humans_pos, const void* humans_goal,
                            const void* humans_radius, const void* placed, void* pos_out,
                            void* goal_out, void* slots, int B, int A, int rounds,
                            double circle_radius, double discomfort_dist,
                            double robot_min_dist, int has_robot_min_dist, void* stream) {
  Params p{};
  p.u = static_cast<const float*>(u);
  p.u_stride = u_stride;
  p.need = static_cast<const unsigned char*>(need);
  p.self_radius = static_cast<const float*>(self_radius);
  p.robot_pos = static_cast<const float*>(robot_pos);
  p.robot_goal = static_cast<const float*>(robot_goal);
  p.robot_radius = static_cast<const float*>(robot_radius);
  p.humans_pos = static_cast<const float*>(humans_pos);
  p.humans_goal = static_cast<const float*>(humans_goal);
  p.humans_radius = static_cast<const float*>(humans_radius);
  p.mask = static_cast<const unsigned char*>(placed);
  p.pos_out = static_cast<float*>(pos_out);
  p.goal_out = static_cast<float*>(goal_out);
  p.slots = static_cast<int*>(slots);
  p.A = A;
  p.rounds = rounds;
  p.circle_radius = static_cast<float>(circle_radius);
  p.discomfort_dist = static_cast<float>(discomfort_dist);
  p.robot_min_dist = static_cast<float>(robot_min_dist);
  p.has_robot_min_dist = has_robot_min_dist;
  // pos, cand, cur_goal; sr, hr; need, placed, pending, accept
  return launch(circle_spawn_kernel, p, B, 3 * sizeof(float2) + 2 * sizeof(float) + 4, stream);
}

// env/spawn.py's batched_goal_resample: new goals `goal_out` (B, A, 2) for
// the slots in `need`, the others' copied from humans_goal; `active` is the
// (B, A) bool of active humans. As circle_spawn otherwise.
extern "C" int goal_resample(const void* u, int64_t u_stride, const void* need,
                             const void* self_radius, const void* v_pref,
                             const void* robot_pos, const void* robot_goal,
                             const void* robot_radius, const void* humans_pos,
                             const void* humans_goal, const void* humans_radius,
                             const void* active, void* goal_out, void* slots, int B, int A,
                             int rounds, double circle_radius, double discomfort_dist,
                             void* stream) {
  Params p{};
  p.u = static_cast<const float*>(u);
  p.u_stride = u_stride;
  p.need = static_cast<const unsigned char*>(need);
  p.self_radius = static_cast<const float*>(self_radius);
  p.v_pref = static_cast<const float*>(v_pref);
  p.robot_pos = static_cast<const float*>(robot_pos);
  p.robot_goal = static_cast<const float*>(robot_goal);
  p.robot_radius = static_cast<const float*>(robot_radius);
  p.humans_pos = static_cast<const float*>(humans_pos);
  p.humans_goal = static_cast<const float*>(humans_goal);
  p.humans_radius = static_cast<const float*>(humans_radius);
  p.mask = static_cast<const unsigned char*>(active);
  p.goal_out = static_cast<float*>(goal_out);
  p.slots = static_cast<int*>(slots);
  p.A = A;
  p.rounds = rounds;
  p.circle_radius = static_cast<float>(circle_radius);
  p.discomfort_dist = static_cast<float>(discomfort_dist);
  // hpos, hgoal; hr; active
  return launch(goal_resample_kernel, p, B, 2 * sizeof(float2) + sizeof(float) + 1, stream);
}
