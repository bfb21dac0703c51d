"""Bring-up check of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printing one JSON line with its seconds before the next starts:

1. device: requires CUDA (exits non-zero otherwise) and prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles every kernel of the evaluation, training and edges/s
   paths with nvcc (sm_90a), one nvcc process per source, all started
   together;
3. kernels: holds K1 (fused graph attention) against its plain PyTorch
   version on the card at every shape the paths give it (rows = 32 for the
   evaluation's cases, 64 for the rollout's envs, 960 for the update's
   minibatch; A = 20 humans, D = 512, 8 heads), at rows = 64 and 960,
   A = 50 (BASELINE config 5's rollout and update) and at rows = 960,
   A = 80 (past the kernels' resident attention), in f32 (atol 3e-4) and bf16
   (atol 3e-2), with a second run that must give the same bits and an
   all-masked row checked for isolation, at rows 64 and 960 x A = 20 under
   scattered masks (``sort_humans=False``: about half the keys valid in no
   prefix order, a row with only column 0 valid), and in bf16 at the edges/s
   bench's own inputs (``bench_edges.sweep_inputs``: rows 480, 1920 and
   7680, x scaled by 0.3), timed there too; holds K2 (its backward)
   against its plain version at the update's shape, at A = 50 and 80, and
   at rows 64 and 960 x A = 20 under scattered masks, in f32 (atol 5e-3 /
   rtol 1e-3) and bf16 (max abs error <= 1e-2 x the largest entry of each
   gradient), with an all-masked row whose dx must be
   0 and a second run that must give the same bits; holds K3 (packed masked
   attention over precomputed q, k, v) against its plain version at the
   edges/s bench's shape (rows = 4096, A = 20, 8 heads, f32), at (960, 50),
   (7, 64), (960, 80) and (16, 256), at head dim 256 (2 heads) and with bf16
   q, k, v at 4096 x 20, to atol 2e-5, with a second run that must give the
   same bits, an all-masked row that must be exactly 0 and leave the other
   rows' bits alone, and masked keys whose v at 1e6 must change no bit; at
   the bench's shape it also times a stream over the same bytes
   (``torch.addcmul`` of q, k and v into one output: the reads and write
   of a pass that loads every key) as a practical floor; K3's bound counts
   the k and v of the valid keys only, and the bound as if every key were
   valid stands beside it; times each beside its plain version, its bound
   and a PyTorch library call or composition (the median over 5 groups of
   back-to-back calls, each group between one pair of CUDA events), and
   reads the device kernels behind one call of each from a torch.profiler
   trace;
4. orca: holds the ORCA kernel (``csrc/orca_solve.cu``, launched by
   ``env/orca.py``'s ``orca_velocity_batch``) against its plain version on
   the card bit for bit, in f32 and f64, with a second run that must give
   the same bits, at the paths' shapes (``utils/orca_oracle.SCENE_SHAPES``:
   1,280 x 21 and 12,800 x 51 egos x lines for the humans of the flagship
   and config 5, 64 x 120 and 500 x 300 for the scripted ORCA robot's truth
   rollout) in seeded crowds (``utils/orca_oracle.scene_tensors``) where a
   fifth to a
   quarter of the egos run LP3; times the kernel (CUDA events over
   back-to-back calls, and its device time from a profiler trace) and the
   plain version (at 500 x 300 in chunks of egos: its LP3 builds (egos, n,
   n, n) tensors) beside the bound (each input read once); fails unless a
   profiler trace of a call holds one device kernel; then the spawn kernel
   (``csrc/human_spawn.cu``, launched by ``env/spawn.py``'s
   ``batched_circle_spawn`` and ``batched_goal_resample``) against its plain
   versions bit for bit, with a second run that must give the same bits, at
   the main path's shapes (``SPAWN_SHAPES``: the events of the flagship, 64
   envs x 20 slots, and of config 5, 256 x 50, a third of the active humans
   in need; a flagship auto-reset of 4 envs, every slot, none placed),
   timed beside its plain version and its bound like the ORCA kernel (one
   device kernel a call);
5. evaluate: loads the committed weights and runs the port's seeded
   evaluation of the flagship pair (trained_models/
   GST_predictor_rand_tpu_r5_selfgst, test cases 0..31 as one batch, K1 in
   bf16 in the policy), with every launch count zeroed just before and read
   just after; fails on a non-finite metric, success_rate < 0.70, or a
   kernel of the path that never launched. The policy's first action is also
   checked against the same weights on the CPU;
6. train: the flagship recipe from the same snapshot (64 envs, 30 steps, 5
   epochs x 2 minibatches, lr 4e-5 with linear decay, K1/K2 in bf16),
   warm-started from the committed policy and GST weights, runs 2
   ``train_iteration``s with the launch counts zeroed just before and read
   just after (K1 = 2 x (31 + 10), K2 = 2 x 10); fails on a non-finite
   loss, on an attention-block module whose params did not change, or on
   another count. Then, on a further rollout: the PPO loss gradient of one
   minibatch through the kernels against the same through the plain
   versions on the card (cosine >= 0.999 over all params, and relative
   error <= 1e-3 on each leaf of the attention block), a timed update, and a
   checkpoint whose params .npz, reloaded with load_policy, must give the
   same deterministic action bit for bit;
7. edges: the edges/s bench (``ops.bench_edges``) at its full shapes,
   ``single_device`` (K3 and its plain version at rows = 4096) and
   ``fused_sweep`` (K1 and its plain version at rows 480, 1920 and 7680),
   with the launch counts zeroed just before and read just after; fails on
   a rate or time that is not finite and positive, or on launch counts
   other than the bench's own (K3 once per timed or warm-up call of
   ``single_device``, K1 once per such call of ``fused_sweep`` at each row
   count, K2 never);
8. scripted: the scripted baselines through ``evaluate`` (32 cases each,
   one batch, cut at 40 steps): the ORCA and the social-force robot in
   CrowdSimVarNum with 20 ORCA humans, and the ORCA robot among 20
   social-force humans; fails on an attention kernel's launch (the path
   has none; ORCA's kernel runs), a non-finite metric, or outcome rates
   that do not sum to 1;
9. variants_eval: the network policy from a seeded ``init_params``
   (untrained: rates printed, not gated) under BASELINE config 1
   (CrowdSimVarNum, 5 humans), config 2 (CrowdSimPred const_vel and truth,
   10 humans) and the truth env with a visible robot, 32 cases each (cut
   at 20 steps), the counts zeroed before and read after each; fails
   unless K1 launched in each (K2 and K3 never);
10. variants_train: one PPO iteration of BASELINE config 5 as the train CLI
   builds it (CrowdSimPredRealGST, 10-50 humans: A = 50; 64 envs x 30
   steps; the committed GST export), K1 at 64 x 50 and 960 x 50 (41
   launches) and K2 at 960 x 50 (10); then the PPO gradient of a further
   rollout's first minibatch through the kernels against the plain
   versions, to the train phase's bounds;
11. unicycle_train: one PPO iteration of the unicycle recipe
   (trained_models/GST_predictor_unicycle_scratch_r5/config.json:
   CrowdSimPredRealGST, 20 humans, unicycle, v_pref 0.6, 64 envs x 30
   steps) with the committed GST export, warm-started from the committed
   flagship policy at total_steps = half the spin-penalty warmup (the
   annealed coefficient 2.25): K1 = 41 and K2 = 10 launches; fails on a
   non-finite loss or rewards without the spin term (one step against the
   same step at coefficient 0); then the gradient check;
12. policy_variants: ``sort_humans=False`` under config 2 (CrowdSimPred
   truth, 10 humans), ``use_hr_attn=False`` and ``use_self_attn=False``
   under the flagship env, DS-RNN under config 1, each from a seeded
   ``init_params`` (rates printed, not gated): 32 cases cut at 20 steps,
   then one PPO iteration (64 envs x 30 steps), the counts read for each:
   K1 in the first two and never in the last two, K2 in the first two
   updates; the gradient check on ``sort_humans=False``'s;
13. gst_train: the GST training stack through the port's entry points.
   ``collect_dataset`` on the card (CrowdSimVarNum, 20 ORCA humans: 16
   envs x 256 steps from seed 0 for train, 4 x 256 from seed 1 for val),
   the records checked as tests/test_gst_training.py:24-32 checks them
   and written as txt files, windows loaded from them (32 slots, obs 5,
   pred 5); one Adam step on the card and one on the CPU from one
   ``init_gst`` and one batch of 64 (loss relative error <= 1e-4, each
   gradient leaf <= 1e-4 of its largest entry, params <= 1e-5 absolute
   where the CPU gradient is >= 1e-6; Adam's first step moves the others,
   rounding noise such as the attention's k bias, anywhere within lr); the
   untrained model's val aoe/foe, then ``trainer.train`` at the JAX
   recipe's full width (``PredConfig()``, batch 64, lr 1e-3) for 4 epochs
   from that init; fails on a non-finite loss or unless the last epoch's
   val aoe and foe are both <= half the untrained model's; the written
   ``epoch_4/params.npz`` reloaded with ``load_gst`` as the flagship env's
   predictor, one ``pretext_process`` batch and ``gst_predict`` on it must
   be finite; K1, K2 and K3 must not launch;
14. parallel: the data-parallel train step (``parallel/``) in a world of
   one process over NCCL (``launch.initialize`` with a FileStore; the
   card's machine has one card, and the multi-rank checks run on gloo in
   tests/test_torch_parallel*.py and tests/test_torch_edge_partition.py).
   One flagship iteration through ``launch.make_global_iteration`` from
   the train phase's warm start, the counts zeroed just before and read
   just after (K1 = 41, K2 = 10), held against the train phase's first
   plain ``ppo.train_iteration`` from the same snapshot (value loss rtol
   1e-4, every param atol 1e-5); the edge-partitioned ring at world size one
   against the dense plain math at rows 256, A 16, D 256, 8 heads (atol
   3e-5), both timed; ``bench_edges.weak_scaling`` and
   ``weak_scaling_train`` at n = 1; fails on another backend than NCCL.
   The group is destroyed at the end;
15. off_path: the modules off the training path, each part timed by
   ``utils/profiling.PhaseTimer`` with the counts zeroed before and read
   after it. native: the port's C++ ORCA engine built with g++, and the
   humans' ORCA velocities of the flagship state (64 envs x 20 humans
   after 5 train steps) on the card in f32 (atol 2e-4 where LP2 is
   feasible, 2e-2 on LP3 egos with one near-tied flip per env or 3% of its
   LP3 egos allowed) and f64 (5e-3) against the engine, the engine against
   the NumPy oracle on 256 egos (1e-9), and 60 engine crowd steps of 8
   agents crossing a circle without interpenetration; lidar: ``scan`` at
   64 envs x 72 rays x 20 humans on the card against the CPU (1e-5 where a
   ray misses, and within the float32 conditioning bound of
   tests/test_torch_lidar.py on hits); gym: CrowdSimPredRealGST-v0 with the
   committed GST export stepped 20 times by the committed policy (rewards
   finite, spatial edges (20, 12)), then CrowdSimVarNum-v0 with the
   scripted ORCA robot for 20 steps, no kernel; record_replay:
   ``record_sim_episode`` of case 0 with the network policy (20 steps),
   its CSVs saved, ``load_actions`` and ``replay_actions`` on the card bit
   for bit, and ``record_episode`` of the same case (cut at 11 steps by the
   time limit) bit-equal to the recording; sim2real: ``Sim2RealEnv`` over
   ``DummyDetectionSource`` (seed 0) for 10 steps of the committed policy,
   the observation contract's shapes and dtypes; rms_profiling:
   ``rms_update`` / ``normalize_obs`` of the rollout's robot_node rows on
   the card against the CPU (1e-6 relative, plus the float32 rounding of
   x - mean over the std of the constant columns), and one gym step under
   ``profiling.trace``, whose trace must hold CUDA kernel events. K1 must
   launch once per policy ``act``, K2 and K3 never. Nothing here draws:
   ``record_episode`` runs, ``render_*`` and ``plot`` do not (the card's
   machine has no matplotlib).

Phases 9 and 12 cut their suites at 20 steps (40 before the off_path
phase came), so the phases but orca stay under 300 s; orca adds ~20 s,
most of it the plain version at 500 x 300.

Every phase from evaluate on counts the ORCA and spawn kernels' launches
beside K1-K3's, zeroed and read at the same points, and fails on another count
than its env steps give (``orca_solves``: one a step for ORCA humans, one
for the ORCA robot, ``buffer_len`` for each truth rollout of the test
phase, the ORCA robot or a ``truth`` env's observation; a ``truth`` env's
training bounded by its auto-resets): train 2 x 30 = 60, the suites
``buffer_len`` + 1 or + 2 a lock-step step; edges none, gst_train some,
off_path reported (the spawn kernel's are reported: one a step for each
event pass, one a reset). The kernels line gives the ORCA and spawn entries
those launches by phase.

The kernels line also gives each kernel's device launches per call and the
registers and spills that ptxas reported for each of its CUDA functions.

The last three lines are the kernels line ({"kernels": [...]}), the card's
name and power limit, and {"ok": true, "device": {...}}. Nothing falls back to the CPU: a phase that
fails ends the run with a non-zero exit code and no result line.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from crowdnav_prediction_attngraph_tpu_torch import sim2real
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.collect_data import (
    collect_dataset, write_records)
from crowdnav_prediction_attngraph_tpu_torch.algo import evaluation
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo
from crowdnav_prediction_attngraph_tpu_torch.config import (
    PredConfig, build_config, config_from_snapshot, pred_config,
    varnum_config)
from crowdnav_prediction_attngraph_tpu_torch.env import (
    crowd_sim, gym_adapter, lidar)
from crowdnav_prediction_attngraph_tpu_torch.env import orca, spawn
from crowdnav_prediction_attngraph_tpu_torch.env.orca import (
    _lp2, orca_lines, orca_velocity_batch)
from crowdnav_prediction_attngraph_tpu_torch.env.pretext import pretext_process
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod
from crowdnav_prediction_attngraph_tpu_torch.models.gst import (
    dataset as gst_dataset, eval as gst_eval, trainer as gst_trainer)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import (
    init_gst)
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    init_hidden, obs_to_dict)
from crowdnav_prediction_attngraph_tpu_torch.ops import (
    _build, bench_edges, masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.parallel import launch
from crowdnav_prediction_attngraph_tpu_torch.parallel.edge_partition import (
    edge_partitioned_attention)
from crowdnav_prediction_attngraph_tpu_torch.parallel.mesh import full_params
from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
    fused_graph_attention, fused_graph_attention_backward,
    packed_masked_attention, reference_fused_graph_attention,
    reference_fused_graph_attention_backward, reference_masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.test import (
    DEFAULT_GST_PARAMS, DEFAULT_PARAMS)
from crowdnav_prediction_attngraph_tpu_torch.runtime import native
from crowdnav_prediction_attngraph_tpu_torch.utils import (
    checkpoint, profiling, render, running_mean_std as rms)
from crowdnav_prediction_attngraph_tpu_torch.utils.orca_oracle import (
    SCENE_SHAPES, SCENE_TIME_HORIZON, SCENE_TIME_STEP, lp2_failures,
    orca_velocity_np, plain_solve, scene_tensors)
from crowdnav_prediction_attngraph_tpu_torch.utils.recorder import Recorder
from crowdnav_prediction_attngraph_tpu_torch.utils.spawn_scenes import (
    circle_spawn_args, goal_resample_args)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, state_dict_to_tree)

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(REPO, "trained_models",
                         "GST_predictor_rand_tpu_r5_selfgst")
UNICYCLE_DIR = os.path.join(REPO, "trained_models",
                            "GST_predictor_unicycle_scratch_r5")
N_CASES = 32
MIN_SUCCESS = 0.70
# the scripted suites' depth: 40 steps (10 s of an episode's
# 49), so that the suites take well under 1 min (with the full
# episodes they took 229 s on an H100 80GB HBM3 at 700 W, 0.06-0.23 s a
# lock-step step, most of it ORCA); the 500-case scores of the test CLI
# run the full episodes. A scripted robot needs ~18 s to its goal on
# average, so few cases end in success within the cut: the scripted phase
# requires one at least, over its three suites
SUITE_STEPS = 40
# the variant and ablation suites' depth (rates printed, not gated): 20
# steps, half the scripted suites', which gives the off_path phase the
# ~19 s it takes and keeps the script under 300 s of phases
VARIANT_STEPS = 20
TRAIN_ITERS = 2
K1_ROWS = (N_CASES, 64, 960)
A, D, HEADS = 20, 512, 8
A_WIDE = 50            # the widest crowd of the repo's configs (10-50 humans)
A_PAST = 80            # past K1's and K2's single-chunk attention (A <= 64)
# variants_eval's crowds: config 1 (5 humans) and config 2 (10 humans), at
# rows N_CASES
A_VARIANTS = (5, 10)
# rows of the scattered-mask checks (sort_humans=False): the rollout's envs
# and the update's minibatch, A = 20
SCATTERED_ROWS = (64, 960)
# K3 (rows, A, heads, dtype): the edges/s bench's shape first (the kernels
# line reports it), the wide crowd, one and several key tiles past the
# bench's, A = 256, head dim 256 and bf16 inputs at the bench's rows
K3_CASES = ((4096, 20, HEADS, torch.float32), (960, A_WIDE, HEADS, torch.float32),
            (7, 64, HEADS, torch.float32), (960, A_PAST, HEADS, torch.float32),
            (16, 256, HEADS, torch.float32), (4096, 20, 2, torch.float32),
            (4096, 20, HEADS, torch.bfloat16))
K3_ATOL = 2e-5
# the shapes the kernels take since their limits went, each against its
# plain version and timed: K1 and K2 (rows, A, D, heads) past A = 256 (the
# tiled attention), head dims 136 and 256 (column chunks), D = 100 (rows not
# a multiple of 16 bytes); K3 (rows, A, D, heads) at head dims 320 and 512
# (split into column chunks of 256)
ANY_K12 = ((64, 300, D, HEADS), (960, 257, D, HEADS), (960, A, 1088, HEADS),
           (960, A, 1024, 4), (960, A, 100, 4))
REPS_ANY = {(64, 300): 3, (960, 257): 2, (960, A): 10}
ANY_K3 = ((1024, 20, 1280, 4), (1024, 20, 2048, 4))
# gst_train: the collect (train and val envs x steps, 20 ORCA humans), the
# JAX recipe's batch and as many epochs as fit the phase's 45 s
GST_TRAIN_ENVS, GST_VAL_ENVS, GST_STEPS = 16, 4, 256
GST_BATCH, GST_EPOCHS, GST_LR = 64, 4, 1e-3
# one Adam step on the card against the CPU: the loss (relative), each
# gradient leaf (relative to its largest entry) and the params (absolute)
# where the gradient is resolved. Adam's first step moves a param by lr x
# g / (|g| + 1e-8): an entry whose gradient is rounding noise (the
# attention's k bias, 0 in exact arithmetic, and any entry below 1e-6 on
# the CPU) moves by an unresolved amount in (-lr, lr) on either device
GST_LOSS_REL, GST_GRAD_REL, GST_PARAM_ABS = 1e-4, 1e-4, 1e-5
GST_RESOLVED = 1e-6
# NVIDIA H100 SXM data-sheet peaks (dense) and memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
ATOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}
K2_BF16_REL = 1e-2
GRADS = ("dx", "dw_qkv", "db_qkv", "dw_out", "db_out")
# human-human attention modules whose params the update must move
ATTN_MODULES = ("embed_0", "embed_1", "q_linear", "k_linear", "v_linear",
                "mha_in_proj", "mha_out_proj")
# each attention leaf's gradient through the kernels against the plain
# versions: ||g_kernel - g_plain|| / ||g_plain|| per leaf. The k bias's
# gradient is zero in exact arithmetic (softmax ignores a shift of every
# logit in a row), so both sides are rounding noise there: that leaf is
# held against the norm of the whole block's gradient instead.
LEAF_REL = 1e-3
ZERO_GRAD_LEAF = "spatial_attn.k_linear.bias"
# parallel: the data-parallel iteration against the plain one (the JAX
# tests' bounds, tests/test_parallel_train.py), and the ring's shape (the
# JAX weak-scaling bench's n = 1: rows, A, D, heads) and tolerance
PARALLEL_RTOL, PARALLEL_ATOL = 1e-4, 1e-5
RING_SHAPE, RING_ATOL = (256, 16, 256, 8), 3e-5
# off_path: the ORCA cross-check's bounds (tests/test_torch_orca.py: f32 on
# egos whose LP2 is feasible, f32 on LP3 egos with one near-tied flip per
# env or 3% of its LP3 egos allowed, f64 on every ego; the engine against
# the NumPy oracle as tests/test_native_orca.py), the egos the oracle
# solves, the lidar's flat bound and the RMS bound (relative to the
# magnitude, card vs CPU reductions)
ORCA_F32_LP2, ORCA_F32_LP3, ORCA_F64, ORCA_ORACLE = 2e-4, 2e-2, 5e-3, 1e-9
ORACLE_EGOS = 256
LIDAR_ATOL, RMS_TOL = 1e-5, 1e-6
# off_path's depth: the gym envs' steps, record_sim_episode's (the replay
# takes as many again) and record_episode's, and sim2real's; a one-env
# test-phase step costs ~0.1 s on an H100, so the records are cut
# to 20 and 10 steps to keep the phase near 15 s
GYM_STEPS, RECORD_STEPS, SIM2REAL_STEPS = 20, 20, 10
RECORD_EPISODE_STEPS = 10


def emit(phase: str, t0: float, **kw):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0,
                                                       3), **kw}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def k1_inputs(rows: int, seed: int, device, a: int = A, d: int = D,
              scattered: bool = False):
    """K1's inputs from a seed. The key mask is a prefix of a random length
    (the detected humans of ``sort_humans``), or, ``scattered``, the
    visibility mask of ``sort_humans=False``: about half the keys valid in
    no prefix order, row 0 with only column 0 valid, column 0 set on rows
    with no valid key (the policy's fallback)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, a, d, generator=g)
    w_qkv = torch.randn(d, 3 * d, generator=g) / math.sqrt(d)
    b_qkv = torch.randn(3 * d, generator=g) * 0.01
    w_out = torch.randn(d, d, generator=g) / math.sqrt(d)
    b_out = torch.randn(d, generator=g) * 0.01
    det = torch.randint(1, a + 1, (rows,), generator=g)
    mask = torch.arange(a)[None, :] < det[:, None]
    if scattered:
        mask = torch.rand(rows, a, generator=g) < 0.5
        mask[0] = False
        mask[~mask.any(-1), 0] = True
        prefix = torch.arange(a)[None, :] < mask.sum(-1, keepdim=True)
        if not (mask != prefix).any(-1).float().mean() > 0.5:
            fail(f"the scattered mask at rows={rows} A={a} is mostly a "
                 f"prefix")
    return [t.to(device) for t in (x, mask, w_qkv, b_qkv, w_out, b_out)]


def k3_inputs(rows: int, a: int, seed: int, device, dtype=torch.float32,
              d: int = D):
    """q, k, v (in ``dtype``) and a key mask with at least one valid key per
    row, made on the card from a seed."""
    g = torch.Generator(device).manual_seed(seed)
    q, k, v = (torch.randn(rows, a, d, generator=g, device=device).to(dtype)
               for _ in range(3))
    det = torch.randint(1, a + 1, (rows,), generator=g, device=device)
    mask = torch.arange(a, device=device)[None, :] < det[:, None]
    return q, k, v, mask


def time_ms(fn, reps: int = 30, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls between one pair of CUDA events, after a warm-up (per-call events
    would read the launch gaps of a ~0.05 ms call)."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` launches, read
    from a torch.profiler trace of that call (after a warm-up call); None
    if the trace holds no device activity. A marker kernel (``spin_kernel``)
    opens the trace and is left out of the names: the trace can miss its
    first kernel, and then it misses the marker."""
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
    except Exception as exc:  # the trace is a report, not a check
        print(f"chip_smoke: profiler unavailable: {exc}", file=sys.stderr)
        return None
    return names or None


def device_ms(fn, calls: int = 20):
    """The mean device time of the kernels one call of ``fn`` runs, from a
    torch.profiler trace of ``calls`` calls after a warm-up call (the events'
    ``time_ms`` of a call shorter than its launch reads the host's rate);
    None if the trace holds no device activity."""
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # the trace is a report, not a check
        print(f"chip_smoke: profiler unavailable: {exc}", file=sys.stderr)
        return None
    return sum(us) / calls / 1e3 if us else None


def ptxas_summary(report: str) -> dict:
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from nvcc's -Xptxas -v report of one source."""
    out, name, spill = {}, None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes " \
                    f"spill loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, {spill}"
            name, spill = None, ""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
        if len(names) == len(out):
            return dict(zip(names, out.values()))
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate for the compute type, and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(rows: int, dtype, a: int = A, d: int = D) -> tuple:
    """K1's work at these shapes: each input read once, the output written
    once; the QKV projection, QK^T and PV, and the output projection."""
    tokens = rows * a
    flops = 2 * tokens * d * 3 * d + 2 * 2 * rows * a * a * d \
        + 2 * tokens * d * d
    nbytes = (4 * tokens * d + tokens
              + 4 * (d * 3 * d + 3 * d + d * d + d)
              + 4 * tokens * d)
    return bound_ms(flops, nbytes, dtype)


def k2_bound_ms(rows: int, dtype, a: int = A, d: int = D) -> tuple:
    """K2's work as the TPU kernel does it, not counting the port's scratch:
    x, g, the mask and the weights read once, dx and the four weight
    gradients written once; 22 T D^2 FLOP of projections (q/k/v recompute
    6, dattn 2, dx 6, dW_qkv 6, dW_out 2) and 12 rows A^2 D of attention
    (logits, P v, dv, dP, dq, dk)."""
    tokens = rows * a
    flops = 22 * tokens * d * d + 12 * rows * a * a * d
    nbytes = (4 * 2 * tokens * d + tokens + 4 * (d * 3 * d + 3 * d + d * d)
              + 4 * tokens * d + 4 * (d * 3 * d + 3 * d + d * d + d))
    return bound_ms(flops, nbytes, dtype)


def k3_bound_ms(q, mask) -> tuple:
    """K3's work on these inputs: q and the mask read once, k and v of the
    valid keys only (a masked key's k and v reach no result), the f32
    output written once; the logits and P v of every (query, valid key)
    pair of every head (4 D A FLOP a valid key) in f32."""
    rows, a, d = q.shape
    valid = int(mask.sum().item())
    es = q.element_size()
    flops = 4 * d * a * valid
    nbytes = (es + 4) * rows * a * d + 2 * es * valid * d + rows * a
    return bound_ms(flops, nbytes, torch.float32)


def k3_bound_all_keys_ms(rows: int, a: int, in_bytes: int,
                         d: int = D) -> float:
    """The bound as if every key were valid (the earlier yardstick): all
    of q, k and v read, all (query, key) pairs computed."""
    flops = 4 * rows * a * a * d
    nbytes = (3 * in_bytes + 4) * rows * a * d + rows * a
    return bound_ms(flops, nbytes, torch.float32)[0]


def k1_library(x, mask, w_qkv, b_qkv, w_out, b_out, dtype, heads=HEADS):
    """One PyTorch composition of the same function (yardstick only):
    addmm -> scaled_dot_product_attention -> addmm in the compute dtype."""
    rows, a, d = x.shape
    xc, wq, wo = x.to(dtype), w_qkv.to(dtype), w_out.to(dtype)
    bq, bo = b_qkv.to(dtype), b_out.to(dtype)
    attn_mask = mask[:, None, None, :]

    def run(xc=xc, wq=wq, bq=bq, wo=wo, bo=bo):
        qkv = torch.addmm(bq, xc.reshape(-1, d), wq).reshape(rows, a, 3, heads,
                                                             d // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask)
        return torch.addmm(bo, o.transpose(1, 2).reshape(-1, d), wo)
    return run


def k2_library(x, mask, w_qkv, b_qkv, w_out, b_out, g, dtype, heads=HEADS):
    """The backward of :func:`k1_library` by autograd (yardstick only): the
    graph is built once, each call runs only the backward."""
    leaves = [t.to(dtype).requires_grad_(True)
              for t in (x, w_qkv, b_qkv, w_out, b_out)]
    out = k1_library(x, mask, w_qkv, b_qkv, w_out, b_out, dtype,
                     heads)(*leaves)
    gc = g.reshape(-1, x.shape[-1]).to(dtype)
    return lambda: torch.autograd.grad(out, leaves, gc, retain_graph=True)


def k3_library(q, k, v, mask, heads: int = HEADS):
    """One PyTorch call of the same function (yardstick only):
    scaled_dot_product_attention with a boolean key mask on (rows, heads, A,
    hd) views of the same inputs, in their dtype, its output left in that
    layout. Rows with no valid key differ (NaN there); the inputs here all
    have one."""
    rows, a, d = q.shape
    qh, kh, vh = (t.view(rows, a, heads, d // heads).transpose(1, 2)
                  for t in (q, k, v))
    attn_mask = mask[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=attn_mask)


def check_k1(rows: int, device, a: int = A, d: int = D,
             heads: int = HEADS, reps: int = 30,
             scattered: bool = False) -> dict:
    args = k1_inputs(rows, seed=rows, device=device, a=a, d=d,
                     scattered=scattered)
    res = {"rows": rows, "A": a, "D": d, "heads": heads,
           "mask": "scattered" if scattered else "prefix"}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        got = fused_graph_attention(*args, heads, compute_dtype=dtype)
        torch.cuda.synchronize()
        expect = reference_fused_graph_attention(*args, heads,
                                                 compute_dtype=dtype)
        err = (got - expect).abs().max().item()
        if not math.isfinite(err) or err > ATOL[dtype]:
            fail(f"K1 {tag} {res['mask']} mask rows={rows}: max abs err "
                 f"{err} > {ATOL[dtype]}")
        res[f"max_abs_err_{tag}"] = err
        if not torch.equal(got, fused_graph_attention(*args, heads,
                                                      compute_dtype=dtype)):
            fail(f"K1 {tag} {res['mask']} mask rows={rows} A={a}: two runs "
                 f"on the same inputs differ")
        # all-masked row: output b_out, other rows untouched
        x, mask = args[0].clone(), args[1].clone()
        mask[1] = False
        out0 = fused_graph_attention(x, mask, *args[2:], heads,
                                     compute_dtype=dtype)
        x[1] = 1e4
        out1 = fused_graph_attention(x, mask, *args[2:], heads,
                                     compute_dtype=dtype)
        keep = torch.arange(rows, device=device) != 1
        if not (torch.equal(out0[1], args[5].expand(a, d))
                and torch.equal(out0[keep], out1[keep])):
            fail(f"K1 {tag} {res['mask']} mask rows={rows}: all-masked row "
                 f"isolation broken")
        res[f"kernel_ms_{tag}"] = time_ms(lambda: fused_graph_attention(
            *args, heads, compute_dtype=dtype), reps)
        res[f"plain_ms_{tag}"] = time_ms(
            lambda: reference_fused_graph_attention(*args, heads,
                                                    compute_dtype=dtype), reps)
        res[f"library_ms_{tag}"] = time_ms(k1_library(*args, dtype, heads),
                                           reps)
        res[f"bound_ms_{tag}"], res[f"bound_by_{tag}"] = k1_bound_ms(
            rows, dtype, a, d)
    return res


def check_k1_edges(device) -> dict:
    """K1 (bf16, as the edges path runs it) against its plain version at
    each of ``fused_sweep``'s inputs, timed beside the plain version, the
    library composition and the bound: {rows: {...}}."""
    bf16 = torch.bfloat16
    res = {}
    for rows, args in bench_edges.sweep_inputs(device=device):
        got = fused_graph_attention(*args, HEADS, compute_dtype=bf16)
        torch.cuda.synchronize()
        expect = reference_fused_graph_attention(*args, HEADS,
                                                 compute_dtype=bf16)
        err = (got - expect).abs().max().item()
        if not math.isfinite(err) or err > ATOL[bf16]:
            fail(f"K1 bf16 at the edges path's rows={rows}: max abs err {err}"
                 f" > {ATOL[bf16]}")
        row = {"max_abs_err": err,
               "ms": time_ms(lambda: fused_graph_attention(
                   *args, HEADS, compute_dtype=bf16), reps=10),
               "plain_ms": time_ms(lambda: reference_fused_graph_attention(
                   *args, HEADS, compute_dtype=bf16), reps=10),
               "library_ms": time_ms(k1_library(*args, bf16), reps=10)}
        row["bound_ms"], row["bound_by"] = k1_bound_ms(rows, bf16)
        res[rows] = row
    return res


def check_k2(rows: int, device, a: int = A, d: int = D,
             heads: int = HEADS, reps: int = 10,
             scattered: bool = False) -> dict:
    x, mask, w_qkv, b_qkv, w_out, b_out = k1_inputs(
        rows, seed=rows + 7, device=device, a=a, d=d, scattered=scattered)
    mask[1] = False                                   # an all-masked row
    g = torch.randn(rows, a, d, generator=torch.Generator().manual_seed(
        rows)).to(device)
    args = (x, mask, w_qkv, b_qkv, w_out, g)
    res = {"rows": rows, "A": a, "D": d, "heads": heads,
           "mask": "scattered" if scattered else "prefix"}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        got = fused_graph_attention_backward(*args, heads, compute_dtype=dtype)
        torch.cuda.synchronize()
        expect = reference_fused_graph_attention_backward(
            *args, heads, compute_dtype=dtype)
        errs = {}
        for name, t, e in zip(GRADS, got, expect):
            err = (t - e).abs().max().item()
            scale = e.abs().max().item()
            errs[name] = err
            ok = (torch.allclose(t, e, rtol=1e-3, atol=5e-3)
                  if dtype == torch.float32 else err <= K2_BF16_REL * scale)
            if not (ok and math.isfinite(err)):
                fail(f"K2 {tag} {res['mask']} mask rows={rows} A={a} D={d} "
                     f"{name}: max abs err {err} (largest entry {scale})")
        if torch.count_nonzero(got[0][1]):
            fail(f"K2 {tag} {res['mask']} mask rows={rows}: the all-masked "
                 f"row's dx is not 0")
        again = fused_graph_attention_backward(*args, heads,
                                               compute_dtype=dtype)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f"K2 {tag} {res['mask']} mask rows={rows}: two runs on the "
                 f"same inputs differ")
        res[f"max_abs_err_{tag}"] = max(errs.values())
        res[f"max_abs_err_by_grad_{tag}"] = errs
        res[f"kernel_ms_{tag}"] = time_ms(lambda: fused_graph_attention_backward(
            *args, heads, compute_dtype=dtype), reps)
        res[f"plain_ms_{tag}"] = time_ms(
            lambda: reference_fused_graph_attention_backward(
                *args, heads, compute_dtype=dtype), reps)
        res[f"library_ms_{tag}"] = time_ms(
            k2_library(x, mask, w_qkv, b_qkv, w_out, b_out, g, dtype, heads),
            reps)
        res[f"bound_ms_{tag}"], res[f"bound_by_{tag}"] = k2_bound_ms(
            rows, dtype, a, d)
    return res


def check_k3(rows: int, a: int, heads: int, dtype, device,
             stream: bool = False, d: int = D) -> dict:
    """K3 against its plain version, a second run, an all-masked row and
    masked keys; timed beside the plain version, SDPA and the bound, and with
    ``stream`` the addcmul pass over the same bytes."""
    tag = f"K3 rows={rows} A={a} D={d} heads={heads} {str(dtype)[6:]}"
    q, k, v, mask = k3_inputs(rows, a, rows + a + heads, device, dtype, d)
    got = packed_masked_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    expect = reference_masked_attention(q, k, v, mask, heads)
    err = (got - expect).abs().max().item()
    if not math.isfinite(err) or err > K3_ATOL:
        fail(f"{tag}: max abs err {err} > {K3_ATOL}")
    if not torch.equal(got, packed_masked_attention(q, k, v, mask, heads)):
        fail(f"{tag}: two runs on the same inputs differ")
    # an all-masked row: exactly 0, every other row's bits unchanged
    mask1 = mask.clone()
    mask1[1] = False
    out1 = packed_masked_attention(q, k, v, mask1, heads)
    keep = torch.arange(rows, device=device) != 1
    if torch.count_nonzero(out1[1]) or not torch.equal(out1[keep], got[keep]):
        fail(f"{tag}: all-masked row not 0 or not isolated")
    # masked keys get no weight: their v at 1e6 changes no bit
    v1 = torch.where(mask[..., None], v, torch.full_like(v, 1e6))
    if not torch.equal(packed_masked_attention(q, k, v1, mask, heads), got):
        fail(f"{tag}: masked keys leak into the output")
    res = {"rows": rows, "A": a, "D": d, "heads": heads,
           "dtype": str(dtype)[6:], "max_abs_err": err,
           "bitwise_second_run": True}
    library = k3_library(q, k, v, mask, heads)
    res["library_max_abs_err"] = (
        library().float().transpose(1, 2).reshape(rows, a, d) - expect
    ).abs().max().item()
    res["ms"] = time_ms(lambda: packed_masked_attention(q, k, v, mask, heads))
    res["plain_ms"] = time_ms(lambda: reference_masked_attention(
        q, k, v, mask, heads))
    res["library_ms"] = time_ms(library)
    res["bound_ms"], res["bound_by"] = k3_bound_ms(q, mask)
    res["bound_frac"] = res["bound_ms"] / res["ms"]
    res["valid_keys_per_row"] = mask.sum().item() / rows
    res["bound_ms_all_keys"] = k3_bound_all_keys_ms(rows, a, q.element_size(),
                                                    d)
    if stream:
        o = torch.empty_like(q)
        res["stream_ms"] = time_ms(lambda: torch.addcmul(q, k, v, out=o))
    return res


@contextlib.contextmanager
def plain_kernels():
    """Route K1 and K2 of the autograd.Function through their plain
    versions on the card (the comparison of the train phase)."""
    saved = (masked_attention._launch_forward,
             masked_attention.fused_graph_attention_backward)
    masked_attention._launch_forward = reference_fused_graph_attention
    masked_attention.fused_graph_attention_backward = \
        reference_fused_graph_attention_backward
    try:
        yield
    finally:
        (masked_attention._launch_forward,
         masked_attention.fused_graph_attention_backward) = saved


ORCA = "orca_solve"
SPAWN = "human_spawn"
ATTENTION = ("K1_fused_graph_attention", "K2_fused_graph_attention_backward",
             "K3_packed_masked_attention")


# the launch tally's names, as this script prints them
COUNT_NAMES = dict(zip(profiling.LAUNCH_NAMES, (*ATTENTION, ORCA, SPAWN)))


def zero_counts():
    profiling.zero_launches()


def read_counts() -> dict:
    return {COUNT_NAMES[k]: n for k, n in profiling.launches().items()}


def attention_counts(launches) -> dict:
    """The attention kernels' counts of ``launches``, without ORCA's and
    the spawn kernel's."""
    return {k: launches[k] for k in ATTENTION}


def orca_solves(cfg, phase: str, robot: str, steps: int,
                resets: int) -> tuple:
    """The ORCA solves (one kernel launch each on the card) that ``steps``
    lock-step ``crowd_sim.step`` calls and ``resets`` ``crowd_sim.reset``
    calls make, as (least, most). A step solves once for ORCA humans, once
    for the ORCA robot, ``buffer_len`` times for the truth rollout of the
    test phase or of the ORCA robot in a predicting env, and as many again
    for a ``truth`` env's observation, which a reset makes too. The most
    adds one auto-reset a step where resets cost solves (a ``truth`` env's
    training: the auto-reset runs only on steps where an env is done)."""
    k = cfg.buffer_len
    predict = cfg.sim.predict_method
    rollout = phase == "test" or (robot == "orca" and predict != "none")
    per_step = (int(cfg.humans.policy == "orca") + int(robot == "orca")
                + (k if rollout else 0) + (k if predict == "truth" else 0))
    per_reset = k if predict == "truth" else 0
    least = steps * per_step + resets * per_reset
    return least, least + (steps * per_reset if phase == "train" else 0)


def check_orca_launches(name, got: int, solves: tuple):
    least, most = solves
    if not least <= got <= most:
        fail(f"{name}: {got} ORCA kernel launches, expected "
             f"{least if least == most else solves}")


def check_orca(egos: int, n: int, device) -> dict:
    """The ORCA kernel against its plain version at one shape: bit-equal in
    f32 and f64, the same bits on a second run, the egos that run LP3 (the
    plain LP2's failures), and both timed. The bound reads each input once
    and writes the result (the ~60 operations a line are far below the
    bytes' time); the plain version is timed in its chunks."""
    out = {"egos": egos, "lines": n}
    def kernel(args):
        return orca_velocity_batch(*args[:9], SCENE_TIME_STEP,
                                   SCENE_TIME_HORIZON, args[9])
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        args = scene_tensors(egos, n, 7, device, dtype)
        got, again = kernel(args), kernel(args)
        plain = plain_solve(args)
        torch.cuda.synchronize()
        out[f"bitwise_{tag}"] = bool(torch.equal(got, plain))
        out[f"bitwise_second_run_{tag}"] = bool(torch.equal(got, again))
        if not (out[f"bitwise_{tag}"] and out[f"bitwise_second_run_{tag}"]):
            fail(f"orca: kernel != plain at {egos} x {n} {tag}: max abs "
                 f"{(got - plain).abs().max().item()}, {out}")
    args = scene_tensors(egos, n, 7, device)
    out["lp3_egos"] = lp2_failures(args)
    out["ms"] = time_ms(lambda: kernel(args), reps=20)
    out["device_ms"] = device_ms(lambda: kernel(args))
    out["plain_ms"] = time_ms(lambda: plain_solve(args), reps=1, groups=3)
    nbytes = sum(t.numel() * t.element_size() for t in args) + egos * 2 * 4
    out["bound_ms"], out["bound_by"] = bound_ms(60.0 * egos * n, nbytes,
                                                torch.float32)
    out["device_kernels"] = device_kernels(lambda: kernel(args))
    return out


def phase_orca(device) -> list:
    """The ORCA kernel at the paths' shapes (``SCENE_SHAPES``); one call
    must run one device kernel, read from a profiler trace, which must
    hold it."""
    t0 = time.perf_counter()
    before = profiling.launches()["orca"]
    shapes = [check_orca(egos, n, device) for egos, n in SCENE_SHAPES]
    launches = profiling.launches()["orca"] - before
    emit("orca", t0, shapes=shapes, launches=launches)
    for m in shapes:
        if m["device_kernels"] is None or len(m["device_kernels"]) != 1:
            fail(f"orca: device kernels of a call at {m['egos']} x "
                 f"{m['lines']}: {m['device_kernels']} (one expected)")
    return shapes


# (entry, envs, slots, need, placed): the flagship's and config 5's events
# and a flagship auto-reset of 4 envs
SPAWN_SHAPES = (("circle_spawn", 64, 20, "random", "rest"),
                ("circle_spawn", 256, 50, "random", "rest"),
                ("circle_spawn", 4, 20, "all", "none"),
                ("goal_resample", 64, 20, "random", None),
                ("goal_resample", 256, 50, "random", None))


def check_spawn(entry: str, envs: int, slots: int, need: str, placed,
                device) -> dict:
    """The spawn kernel's ``entry`` against its plain version at one shape:
    bit-equal, the same bits on a second run, both timed. The bound reads
    each input once and writes the outputs, and counts the rounds' tests as
    if every slot were pending in every round against every slot (two
    distances, ~14 operations)."""
    if entry == "circle_spawn":
        args = circle_spawn_args(envs, slots, envs + slots, device, need,
                                 placed)
        kernel, plain = spawn.batched_circle_spawn, \
            spawn.reference_circle_spawn
        rounds, outs = spawn.SPAWN_ROUNDS, 2
    else:
        args = goal_resample_args(envs, slots, envs + slots, device, need)
        kernel, plain = spawn.batched_goal_resample, \
            spawn.reference_goal_resample
        rounds, outs = spawn.GOAL_ROUNDS, 1

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]
    got, again, want = (flat(f(*args)) for f in (kernel, kernel, plain))
    torch.cuda.synchronize()
    out = {"entry": entry, "envs": envs, "slots": slots,
           "in_need": int(args[1].sum()),
           "bitwise": all(torch.equal(x, y) for x, y in zip(got, want)),
           "bitwise_second_run": all(torch.equal(x, y)
                                     for x, y in zip(got, again))}
    if not (out["bitwise"] and out["bitwise_second_run"]):
        fail(f"spawn: kernel != plain at {entry} {envs} x {slots}: {out}")
    out["ms"] = time_ms(lambda: kernel(*args), reps=20)
    out["device_ms"] = device_ms(lambda: kernel(*args))
    out["plain_ms"] = time_ms(lambda: plain(*args), reps=3, groups=3)
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor)) + outs * envs * slots * 8
    out["bound_ms"], out["bound_by"] = bound_ms(
        14.0 * rounds * envs * slots * slots, nbytes, torch.float32)
    out["device_kernels"] = device_kernels(lambda: kernel(*args))
    return out


def phase_spawn(device) -> list:
    """The spawn kernel at the main path's shapes (``SPAWN_SHAPES``); one
    call must run one device kernel, read from a profiler trace."""
    t0 = time.perf_counter()
    before = profiling.launches()["spawn"]
    shapes = [check_spawn(*shape, device) for shape in SPAWN_SHAPES]
    emit("spawn", t0, shapes=shapes,
         launches=profiling.launches()["spawn"] - before)
    for m in shapes:
        if m["device_kernels"] is None or len(m["device_kernels"]) != 1:
            fail(f"spawn: device kernels of a call at {m['entry']} "
                 f"{m['envs']} x {m['slots']}: {m['device_kernels']} (one "
                 f"expected)")
    return shapes


def phase_evaluate(cfg, gst, device) -> dict:
    t0 = time.perf_counter()
    policy = pmod.load_policy(cfg, DEFAULT_PARAMS, device)

    # the policy on the card (kernel) against the same weights on the CPU
    # (plain K1), on the first observation of the suite
    gens = [evaluation.case_generator(cfg.ppo.seed, i) for i in range(4)]
    st, ob = crowd_sim.reset(cfg, gens, device)
    st, ob, _, _ = pretext_process(cfg, gst, st, ob, torch.zeros(4,
                                                                 device=device))
    obs_d = obs_to_dict(ob)
    _, act_gpu, _, _ = pmod.act(policy, obs_d, init_hidden(cfg, 4, device),
                                torch.ones(4, device=device))
    policy_cpu = pmod.load_policy(cfg, DEFAULT_PARAMS, "cpu")
    _, act_cpu, _, _ = pmod.act(policy_cpu, {k: v.cpu() for k, v in
                                             obs_d.items()},
                                init_hidden(cfg, 4, "cpu"), torch.ones(4))
    act_err = (act_gpu.cpu() - act_cpu).abs().max().item()
    if not act_err <= 5e-2:
        fail(f"policy action on the card vs the CPU differs by {act_err}")

    zero_counts()
    torch.cuda.synchronize()
    t_eval = time.perf_counter()
    res = evaluation.evaluate(cfg, policy, gst, test_size=N_CASES,
                              batch_size=N_CASES, device=device,
                              log=lambda m: None)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_eval
    launches = read_counts()
    check_orca_launches("evaluate", launches[ORCA], orca_solves(
        cfg, "test", "network", res["env_steps"] // N_CASES, 1))
    line = evaluation.format_results(res)
    metrics = {k: res[k] for k in ("success_rate", "collision_rate",
                                   "timeout_rate", "nav_time", "path_length",
                                   "intrusion_ratio", "min_intrusion_dist",
                                   "mean_episode_reward")}
    emit("evaluate", t0, cases=N_CASES, metrics_line=line, metrics=metrics,
         collision_cases=res["collision_cases"],
         timeout_cases=res["timeout_cases"], env_steps=res["env_steps"],
         eval_seconds=eval_s, env_steps_per_s=res["env_steps"] / eval_s,
         launches=launches, policy_action_err_vs_cpu=act_err)
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"non-finite metric: {metrics}")
    if res["success_rate"] < MIN_SUCCESS:
        fail(f"success_rate {res['success_rate']} < {MIN_SUCCESS}")
    if launches["K1_fused_graph_attention"] == 0:
        fail("K1 was never launched on the evaluation path")
    return launches


def grad_check(cfg, model, batch, device) -> tuple:
    """The PPO loss gradient of the batch's first minibatch through the
    kernels against the same through the plain versions on the card:
    (cosine over all params, relative error over all params, the worst
    attention-block leaf {"name", "rel_err"}); fails past the bounds."""
    p = cfg.ppo
    returns, adv_n = ppo.advantages(cfg, batch)
    idx = torch.arange(p.num_processes // p.num_mini_batch, device=device)
    names, params = zip(*model.named_parameters())

    def grad():
        loss, _ = ppo.ppo_loss(cfg, model, batch, returns, adv_n, idx)
        return dict(zip(names, torch.autograd.grad(loss, params)))
    g_kernel = grad()
    with plain_kernels():
        g_plain = grad()
    flat_k, flat_p = (torch.cat([t.flatten() for t in g.values()])
                      for g in (g_kernel, g_plain))
    cosine = torch.nn.functional.cosine_similarity(flat_k, flat_p,
                                                   dim=0).item()
    rel = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    if not cosine >= 0.999:
        fail(f"PPO gradient through the kernels vs the plain versions: "
             f"cosine {cosine}")
    # each leaf of the attention block on its own, so a fault there is not
    # hidden by the rest of the network's larger gradients
    attn = [k for k in names if any(f"spatial_attn.{m}" in k
                                    for m in ATTN_MODULES)]
    attn_norm = torch.cat([g_plain[k].flatten() for k in attn]).norm()
    leaf_rel = {}
    for k in attn:
        diff = (g_kernel[k] - g_plain[k]).norm()
        floor = attn_norm if k.endswith(ZERO_GRAD_LEAF) else g_plain[k].norm()
        leaf_rel[k] = (diff / floor).item()
    worst = max(leaf_rel, key=leaf_rel.get)
    if not leaf_rel[worst] <= LEAF_REL:
        fail(f"PPO gradient of {worst} through the kernels vs the plain "
             f"versions: relative error {leaf_rel[worst]} > {LEAF_REL}")
    return cosine, rel, {"name": worst, "rel_err": leaf_rel[worst]}


def phase_train(cfg, gst, device) -> dict:
    t0 = time.perf_counter()
    p = cfg.ppo
    model = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device, model)
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    init_s = time.perf_counter() - t0

    zero_counts()
    torch.cuda.synchronize()
    iter_s, metrics = [], []
    for i in range(TRAIN_ITERS):
        t_it = time.perf_counter()
        ts, m = ppo.train_iteration(cfg, ts, gst)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t_it)
        metrics.append({k: float(m[k]) for k in ("value_loss", "action_loss",
                                                 "dist_entropy",
                                                 "reward_mean")})
        if i == 0:
            # the parallel phase's reference: the first iteration from the
            # warm start
            first = ({k: v.clone() for k, v in ts.model.state_dict().items()},
                     float(m["value_loss"]))
    launches = read_counts()
    n_updates = p.ppo_epoch * p.num_mini_batch
    expect = {"K1_fused_graph_attention":
              TRAIN_ITERS * (p.num_steps + 1 + n_updates),
              "K2_fused_graph_attention_backward": TRAIN_ITERS * n_updates,
              "K3_packed_masked_attention": 0}
    if attention_counts(launches) != expect:
        fail(f"train launches {launches}, expected {expect}")
    check_orca_launches("train", launches[ORCA], orca_solves(
        cfg, "train", "network", TRAIN_ITERS * p.num_steps, 0))
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        fail(f"non-finite train metric: {metrics}")
    after = ts.model.state_dict()
    if not all(torch.isfinite(v).all() for v in after.values()):
        fail("non-finite params after the update")
    unchanged = [mod for mod in ATTN_MODULES
                 if all(torch.equal(before[k], after[k]) for k in before
                        if f"spatial_attn.{mod}" in k)]
    if unchanged:
        fail(f"params of {unchanged} did not change in the update")

    # a further rollout, timed; the PPO loss gradient of its first
    # minibatch through the kernels and through the plain versions
    torch.cuda.synchronize()
    t_ro = time.perf_counter()
    ts, batch = ppo.rollout(cfg, ts, gst)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t_ro
    cosine, rel, worst_leaf = grad_check(cfg, ts.model, batch, device)

    torch.cuda.synchronize()
    t_up = time.perf_counter()
    ppo.ppo_update(cfg, ts.model, ts.optimizer, ts.schedule, batch,
                   ts.generator)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t_up

    # checkpoint round trip: the params .npz drives the same action
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, ".torch_build")) \
            as tmp:
        checkpoint.save_train_state(tmp, ts, TRAIN_ITERS)
        reloaded = pmod.load_policy(cfg, os.path.join(
            tmp, f"{TRAIN_ITERS:05d}.npz"), device)
        resumed, nxt = checkpoint.restore_train_state(tmp, ts)
    _, a_run, _, _ = pmod.act(ts.model, ts.obs, ts.hxs, ts.masks)
    _, a_npz, _, _ = pmod.act(reloaded, ts.obs, ts.hxs, ts.masks)
    if not (torch.equal(a_run, a_npz) and nxt == TRAIN_ITERS + 1):
        fail("checkpoint round trip: the reloaded params act differently")

    steps = p.num_steps * p.num_processes
    emit("train", t0, iterations=TRAIN_ITERS, envs=p.num_processes,
         steps=p.num_steps, ppo_epoch=p.ppo_epoch,
         num_mini_batch=p.num_mini_batch, lr=p.lr,
         linear_lr_decay=p.use_linear_lr_decay, init_seconds=init_s,
         iteration_seconds=iter_s, metrics=metrics, launches=launches,
         rollout_seconds=rollout_s, rollout_env_steps_per_s=steps / rollout_s,
         update_seconds=update_s, grad_cosine_kernel_vs_plain=cosine,
         grad_rel_err_kernel_vs_plain=rel, grad_worst_attn_leaf=worst_leaf)
    return launches, first


def _suite_metrics(res, name) -> dict:
    """The evaluation's metrics, checked: outcomes exclusive and covering
    every case (the three rates sum to 1), every metric finite (the
    positions that the path length sums)."""
    metrics = {k: res[k] for k in ("success_rate", "collision_rate",
                                   "timeout_rate", "nav_time", "path_length",
                                   "intrusion_ratio", "min_intrusion_dist",
                                   "mean_episode_reward")}
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{name}: non-finite metric: {metrics}")
    total = (res["success_rate"] + res["collision_rate"]
             + res["timeout_rate"])
    if abs(total - 1.0) > 1e-9:
        fail(f"{name}: the outcome rates sum to {total}, not 1")
    return metrics


def run_suites(suites, device, policy_of, gst=None,
               max_steps: int = SUITE_STEPS) -> tuple:
    """Each (name, cfg, robot policy) as one 32-case batch of ``max_steps``
    steps, the launch counts zeroed just before and read just after each:
    ({name: result}, launches summed over the suites). ``gst`` is the
    predictor of the ``inferred`` env (unused by the others)."""
    runs, total = {}, {}
    for name, cfg, robot in suites:
        policy = policy_of(cfg)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = evaluation.evaluate(cfg, policy, gst, test_size=N_CASES,
                                  batch_size=N_CASES, device=device,
                                  log=lambda m: None, robot_policy=robot,
                                  max_steps=max_steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read_counts()
        check_orca_launches(name, launches[ORCA], orca_solves(
            cfg, "test", robot, res["env_steps"] // N_CASES, 1))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs[name] = {
            "env_name": cfg.env_name, "predict_method": cfg.sim.predict_method,
            "humans": cfg.sim.human_num, "human_policy": cfg.humans.policy,
            "robot_visible": cfg.robot.visible, "robot_policy": robot,
            "metrics": _suite_metrics(res, name),
            "collision_cases": res["collision_cases"],
            "timeout_cases": res["timeout_cases"],
            "env_steps": res["env_steps"], "seconds": secs,
            "env_steps_per_s": res["env_steps"] / secs, "launches": launches}
    return runs, total


def phase_scripted(device) -> dict:
    """The scripted baselines (no attention kernel): the ORCA and the
    social-force robot in CrowdSimVarNum with 20 ORCA humans, and the ORCA
    robot among 20 social-force humans, 32 cases each."""
    t0 = time.perf_counter()
    varnum = varnum_config(human_num=20)
    sf_humans = varnum.replace(humans=dataclasses.replace(
        varnum.humans, policy="social_force"))
    runs, launches = run_suites(
        (("orca_robot", varnum, "orca"),
         ("social_force_robot", varnum, "social_force"),
         ("orca_robot_social_force_humans", sf_humans, "orca")),
        device, lambda cfg: None)
    emit("scripted", t0, cases=N_CASES, max_steps=SUITE_STEPS, runs=runs,
         launches=launches)
    if any(attention_counts(launches).values()):
        fail(f"scripted: an attention kernel launched on a path that has "
             f"none: {launches}")
    if not any(run["metrics"]["success_rate"] > 0 for run in runs.values()):
        fail(f"scripted: no case reached its goal in {SUITE_STEPS} steps")
    return launches


def phase_variants_eval(device) -> dict:
    """The network policy, from a seeded init_params (untrained: rates are
    printed, not gated), under BASELINE config 1 (CrowdSimVarNum, 5
    humans), config 2 (CrowdSimPred const_vel and truth, 10 humans) and the
    truth env with a robot the humans see, 32 cases each cut at
    VARIANT_STEPS; K1 must launch in each (rows 32 x A = 5 / 10)."""
    t0 = time.perf_counter()
    truth = pred_config("truth", human_num=10)
    runs, launches = run_suites(
        (("config1_varnum", varnum_config(human_num=5), "network"),
         ("config2_const_vel", pred_config("const_vel", human_num=10),
          "network"),
         ("config2_truth", truth, "network"),
         ("config2_truth_robot_visible", truth.replace(
             robot=dataclasses.replace(truth.robot, visible=True)),
          "network")),
        device, lambda cfg: pmod.init_params(
            cfg, torch.Generator().manual_seed(cfg.ppo.seed), device),
        max_steps=VARIANT_STEPS)
    emit("variants_eval", t0, cases=N_CASES, max_steps=VARIANT_STEPS,
         runs=runs, launches=launches)
    for name, run in runs.items():
        got = run["launches"]
        if not (got["K1_fused_graph_attention"] > 0
                and got["K2_fused_graph_attention_backward"] == 0
                and got["K3_packed_masked_attention"] == 0):
            fail(f"variants_eval {name}: launches {got}")
    return launches


def phase_variants_train(device) -> dict:
    """One PPO iteration of BASELINE config 5 through the train CLI's
    config (CrowdSimPredRealGST, 10-50 humans, so A = 50; 64 envs x 30
    steps, 5 epochs x 2 minibatches, GST bf16 with the committed export)
    from a seeded init_params: K1 at rows 64 x 50 (31 launches) and 960 x 50
    (10), K2 at 960 x 50 (10), the launch counts zeroed just before and
    read just after; then the PPO gradient of a further rollout's first
    minibatch through the kernels against the plain versions, to the train
    phase's bounds."""
    t0 = time.perf_counter()
    cfg = build_config(train_cli._parser().parse_args(
        ["--env-name", "CrowdSimPredRealGST", "--human-num", "30",
         "--human-num-range", "20", "--num-processes", "64",
         "--use-linear-lr-decay"]))
    p = cfg.ppo
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device)
    a = ts.obs["spatial_edges"].shape[1]
    if a != 50:
        fail(f"variants_train: A = {a}, expected 50")
    zero_counts()
    torch.cuda.synchronize()
    t_it = time.perf_counter()
    ts, m = ppo.train_iteration(cfg, ts, gst)
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t_it
    launches = read_counts()
    n_updates = p.ppo_epoch * p.num_mini_batch
    expect = {"K1_fused_graph_attention": p.num_steps + 1 + n_updates,
              "K2_fused_graph_attention_backward": n_updates,
              "K3_packed_masked_attention": 0}
    metrics = {k: float(m[k]) for k in ("value_loss", "action_loss",
                                        "dist_entropy", "reward_mean")}
    humans = ts.env_states.human_num
    t_ro = time.perf_counter()
    ts, batch = ppo.rollout(cfg, ts, gst)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t_ro
    cosine, rel, worst = grad_check(cfg, ts.model, batch, device)
    emit("variants_train", t0, config="gst_config(human_num=30, "
         "human_num_range=20)", A=a, envs=p.num_processes, steps=p.num_steps,
         iteration_seconds=iter_s,
         iteration_env_steps_per_s=p.num_steps * p.num_processes / iter_s,
         rollout_seconds=rollout_s,
         rollout_env_steps_per_s=p.num_steps * p.num_processes / rollout_s,
         humans_min_max=[int(humans.min()), int(humans.max())],
         metrics=metrics, launches=launches,
         grad_cosine_kernel_vs_plain=cosine, grad_rel_err_kernel_vs_plain=rel,
         grad_worst_attn_leaf=worst)
    if attention_counts(launches) != expect:
        fail(f"variants_train launches {launches}, expected {expect}")
    check_orca_launches("variants_train", launches[ORCA], orca_solves(
        cfg, "train", "network", p.num_steps, 0))
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"variants_train: non-finite metric {metrics}")
    return launches


def _cloned_gens(states):
    """``states`` with copies of its env generators, so that a step taken
    for a check leaves the run's streams where they were."""
    gens = []
    for g in states.gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        gens.append(c)
    return dataclasses.replace(states, gens=gens)


def phase_unicycle_train(gst, device) -> dict:
    """One PPO iteration of the unicycle recipe
    (trained_models/GST_predictor_unicycle_scratch_r5/config.json:
    CrowdSimPredRealGST, 20 humans drawn from [1, 20], unicycle, v_pref 0.6,
    64 envs x 30 steps, the spin penalty annealed over 8 M env steps) with
    the committed GST export as its predictor (the run's own is not in the
    repo), warm-started from the committed flagship policy (the JAX
    package's holonomic-to-unicycle curriculum, ``--init-params-from``) at
    total_steps = half the warmup, so the annealed coefficient is live
    (2.25). Launch counts zeroed just before and read just after the
    iteration: K1 = 31 + 10, K2 = 10. Fails on a non-finite loss, or on
    rewards without the spin term: one step of the policy's actions at the
    annealed coefficient against the same step at 0 must differ by
    -2.25 r^2. Then the PPO gradient check of a further rollout's first
    minibatch, to the train phase's bounds."""
    t0 = time.perf_counter()
    cfg = config_from_snapshot(os.path.join(UNICYCLE_DIR, "config.json"))
    p, r = cfg.ppo, cfg.reward
    if not (cfg.action_space.kinematics == "unicycle"
            and r.spin_penalty_warmup_steps > 0):
        fail(f"unicycle_train: {UNICYCLE_DIR} is not an annealed unicycle "
             f"run")
    ts = ppo.init_train_state(cfg, gst, device,
                              pmod.load_policy(cfg, DEFAULT_PARAMS, device))
    ts = dataclasses.replace(ts, total_steps=r.spin_penalty_warmup_steps // 2)
    coef = ppo.spin_coefficient(cfg, ts.total_steps, "train", device)
    if coef is None or abs(coef.item() - r.spin_penalty_factor / 2) > 1e-6:
        fail(f"unicycle_train: spin coefficient {coef} at half the warmup")
    zero_counts()
    torch.cuda.synchronize()
    t_it = time.perf_counter()
    ts, m = ppo.train_iteration(cfg, ts, gst)
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t_it
    launches = read_counts()
    n_updates = p.ppo_epoch * p.num_mini_batch
    expect = {"K1_fused_graph_attention": p.num_steps + 1 + n_updates,
              "K2_fused_graph_attention_backward": n_updates,
              "K3_packed_masked_attention": 0}
    metrics = {k: float(m[k]) for k in ("value_loss", "action_loss",
                                        "dist_entropy", "reward_mean")}
    if attention_counts(launches) != expect:
        fail(f"unicycle_train launches {launches}, expected {expect}")
    check_orca_launches("unicycle_train", launches[ORCA], orca_solves(
        cfg, "train", "network", p.num_steps, 0))
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"unicycle_train: non-finite metric {metrics}")

    # the rewards hold the spin term: the same step at coefficient 0
    states = ts.env_states
    _, action, _, _ = pmod.act(ts.model, ts.obs, ts.hxs, ts.masks)
    coef = ppo.spin_coefficient(cfg, ts.total_steps, "train", device)
    rew = crowd_sim.step(cfg, _cloned_gens(states), action, "train",
                         spin_coef=coef)[2]
    rew0 = crowd_sim.step(cfg, _cloned_gens(states), action, "train",
                          spin_coef=0.0)[2]
    turn = action[:, 1].clamp(-0.06, 0.06)
    spin = rew - rew0
    spin_err = (spin + coef * turn ** 2).abs().max().item()
    if not (spin_err <= 1e-5 and spin.abs().max().item() > 0):
        fail(f"unicycle_train: the rewards lack the spin term (largest "
             f"term {spin.abs().max().item()}, error {spin_err})")
    speed = states.desired_velocity
    humans = states.human_num

    t_ro = time.perf_counter()
    ts, batch = ppo.rollout(cfg, ts, gst)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t_ro
    cosine, rel, worst = grad_check(cfg, ts.model, batch, device)
    steps = p.num_steps * p.num_processes
    emit("unicycle_train", t0, config=os.path.relpath(UNICYCLE_DIR, REPO),
         envs=p.num_processes, steps=p.num_steps, v_pref=cfg.robot.v_pref,
         total_steps_at_start=r.spin_penalty_warmup_steps // 2,
         spin_coef=coef.item(), iteration_seconds=iter_s,
         iteration_env_steps_per_s=steps / iter_s, rollout_seconds=rollout_s,
         rollout_env_steps_per_s=steps / rollout_s,
         humans_min_max=[int(humans.min()), int(humans.max())],
         desired_velocity_min_max=[speed.min().item(), speed.max().item()],
         spin_term_max=spin.abs().max().item(), spin_term_err=spin_err,
         metrics=metrics, launches=launches,
         grad_cosine_kernel_vs_plain=cosine, grad_rel_err_kernel_vs_plain=rel,
         grad_worst_attn_leaf=worst)
    return launches


def phase_policy_variants(gst, device) -> dict:
    """The ablations and DS-RNN as the train CLI builds their envs, each
    from a seeded init_params (untrained: rates printed, not gated), full
    widths: 32 cases cut at VARIANT_STEPS, then one PPO iteration (64 envs x
    30 steps, 5 epochs x 2 minibatches), the counts zeroed before and read
    after each. ``sort_humans=False`` under BASELINE config 2
    (CrowdSimPred truth, 10 humans, left unsorted: K1 and K2 under the
    env's scattered visibility masks), ``use_hr_attn=False`` and
    ``use_self_attn=False`` under the flagship env (CrowdSimPredRealGST, 20
    humans, the committed GST export), DS-RNN under BASELINE config 1
    (CrowdSimVarNum, 5 humans). K1 must launch in the first two and never
    in the last two; K2 must launch in the ``sort_humans=False`` update,
    whose gradient is checked against the plain versions."""
    t0 = time.perf_counter()

    def cli(*flags, policy="selfAttn_merge_srnn", **net):
        cfg = build_config(train_cli._parser().parse_args(
            list(flags) + ["--num-processes", "64", "--use-linear-lr-decay"]))
        return cfg.replace(
            robot=dataclasses.replace(cfg.robot, policy=policy),
            network=dataclasses.replace(cfg.network, **net))
    gst_env = ("--env-name", "CrowdSimPredRealGST", "--human-num", "20")
    variants = (
        ("sort_humans_false", cli("--env-name", "CrowdSimPred",
                                  "--predict-method", "truth",
                                  "--human-num", "10", sort_humans=False),
         True),
        ("no_hr_attn", cli(*gst_env, use_hr_attn=False), True),
        ("no_self_attn", cli(*gst_env, use_self_attn=False), False),
        ("srnn", cli("--env-name", "CrowdSimVarNum", "--human-num", "5",
                     policy="srnn"), False))
    runs, total = {}, {}
    for name, cfg, attends in variants:
        p = cfg.ppo
        model = pmod.init_params(cfg, torch.Generator().manual_seed(p.seed),
                                 device)
        g = gst if cfg.sim.predict_method == "inferred" else None
        suite, eval_launches = run_suites(((name, cfg, "network"),), device,
                                          lambda c: model, g, VARIANT_STEPS)
        ts = ppo.init_train_state(cfg, g, device, model)
        zero_counts()
        torch.cuda.synchronize()
        t_it = time.perf_counter()
        ts, m = ppo.train_iteration(cfg, ts, g)
        torch.cuda.synchronize()
        iter_s = time.perf_counter() - t_it
        train_launches = read_counts()
        metrics = {k: float(m[k]) for k in ("value_loss", "action_loss",
                                            "dist_entropy", "reward_mean")}
        run = {"env_name": cfg.env_name,
               "predict_method": cfg.sim.predict_method,
               "humans": cfg.sim.human_num, "robot_policy": cfg.robot.policy,
               "sort_humans": cfg.network.sort_humans,
               "use_self_attn": cfg.network.use_self_attn,
               "use_hr_attn": cfg.network.use_hr_attn,
               "eval": suite[name], "iteration_seconds": iter_s,
               "train_metrics": metrics, "train_launches": train_launches}
        n_updates = p.ppo_epoch * p.num_mini_batch
        expect = {"K1_fused_graph_attention":
                  p.num_steps + 1 + n_updates if attends else 0,
                  "K2_fused_graph_attention_backward":
                  n_updates if attends else 0,
                  "K3_packed_masked_attention": 0}
        k1_eval = eval_launches["K1_fused_graph_attention"]
        if (attention_counts(train_launches) != expect
                or (k1_eval > 0) != attends
                or eval_launches["K2_fused_graph_attention_backward"]
                or eval_launches["K3_packed_masked_attention"]):
            fail(f"policy_variants {name}: launches {eval_launches} in the "
                 f"suite and {train_launches} in the iteration, expected "
                 f"K1 {'> 0' if attends else '= 0'} and {expect}")
        check_orca_launches(f"policy_variants {name} iteration",
                            train_launches[ORCA], orca_solves(
                                cfg, "train", "network", p.num_steps, 0))
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"policy_variants {name}: non-finite metric {metrics}")
        if name == "sort_humans_false":
            vis = ts.obs["visible_masks"]
            prefix = (torch.arange(vis.shape[1], device=device)[None]
                      < vis.sum(-1, keepdim=True))
            run["rows_not_a_prefix"] = (vis != prefix).any(-1).float() \
                .mean().item()
            ts, batch = ppo.rollout(cfg, ts, g)
            cosine, rel, worst = grad_check(cfg, ts.model, batch, device)
            run.update(grad_cosine_kernel_vs_plain=cosine,
                       grad_rel_err_kernel_vs_plain=rel,
                       grad_worst_attn_leaf=worst)
        runs[name] = run
        for launches in (eval_launches, train_launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    emit("policy_variants", t0, cases=N_CASES, max_steps=VARIANT_STEPS,
         runs=runs, launches=total)
    return total


def _gst_step(pc, tree, batch, device) -> tuple:
    """One Adam step of the port's trainer on ``device`` from ``tree``:
    (loss, the flat gradients, the flat params after the step)."""
    model = load_gst(pc, tree, device).train()
    opt = gst_trainer.make_optimizer(model, GST_LR)
    loss, _ = gst_trainer.loss_fn(model, gst_trainer.to_device(batch, device),
                                  0.5, False)
    loss.backward()
    grads = flatten_tree(state_dict_to_tree(
        {n: p.grad for n, p in model.named_parameters()}))
    opt.step()
    return (loss.item(), grads,
            flatten_tree(state_dict_to_tree(model.state_dict())))


def _gst_card_vs_cpu(pc, tree, batch, device) -> dict:
    """One Adam step on the card and on the CPU from the same params and
    batch, held to GST_LOSS_REL, GST_GRAD_REL and, on the entries whose CPU
    gradient is >= GST_RESOLVED, GST_PARAM_ABS; the others to lr."""
    loss_d, g_d, p_d = _gst_step(pc, tree, batch, device)
    loss_c, g_c, p_c = _gst_step(pc, tree, batch, "cpu")
    p0 = flatten_tree(tree)
    grad_rel = param_err = free_step = 0.0
    worst, unresolved = None, 0
    for k in p_c:
        grad_rel = max(grad_rel, float(np.abs(g_d[k] - g_c[k]).max()
                                       / max(np.abs(g_c[k]).max(), 1e-30)))
        res = np.abs(g_c[k]) >= GST_RESOLVED
        unresolved += int((~res).sum())
        err = float(np.abs(p_d[k] - p_c[k])[res].max(initial=0.0))
        if err > param_err:
            param_err, worst = err, k
        free_step = max(free_step, *(float(np.abs(p[k] - p0[k])[~res]
                                           .max(initial=0.0))
                                     for p in (p_d, p_c)))
    out = {"loss_rel_err": abs(loss_d - loss_c) / abs(loss_c),
           "grad_max_rel_err_by_leaf_max": grad_rel,
           "params_max_abs_err_resolved": param_err,
           "params_worst_leaf": worst, "unresolved_entries": unresolved,
           "entries": sum(v.size for v in p_c.values()),
           "unresolved_max_step": free_step}
    if not (out["loss_rel_err"] <= GST_LOSS_REL and grad_rel <= GST_GRAD_REL
            and param_err <= GST_PARAM_ABS
            and free_step <= GST_LR * (1 + 1e-6)):
        fail(f"gst_train: one Adam step on the card vs the CPU: {out}")
    return out


def phase_gst_train(cfg, device, smi) -> dict:
    """The GST training stack through the port's entry points: collect ORCA
    crowds on the card, load windows from the written files, hold one Adam
    step on the card against the CPU, train, reload the checkpoint for the
    env's predictor. No K1/K2/K3 on this path: their counts must stay 0."""
    t0 = time.perf_counter()
    zero_counts()
    env_cfg = varnum_config(human_num=20)
    pc = PredConfig()
    t_c = time.perf_counter()
    train_rows = collect_dataset(env_cfg, GST_TRAIN_ENVS, GST_STEPS, seed=0,
                                 device=device)
    val_rows = collect_dataset(env_cfg, GST_VAL_ENVS, GST_STEPS, seed=1,
                               device=device)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t_c
    for i, rows in enumerate(train_rows + val_rows):
        if (len(rows) == 0 or np.any(np.diff(rows[:, 0]) < 0)
                or np.any(rows[:, 1] < 0)
                or not np.all(np.isfinite(rows[:, 2:]))
                or np.any(np.abs(rows[:, 2:]) >= 30)):
            fail(f"gst_train: env {i}'s records fail the collect checks "
                 "(empty, frames not increasing, a negative id, or a "
                 "position not finite or past 30 m)")
    with tempfile.TemporaryDirectory() as d:
        t_w = time.perf_counter()
        for split, rows in (("train", train_rows), ("test", val_rows)):
            write_records(os.path.join(d, "data", split), rows)
        train_w, val_w = (gst_dataset.load_dataset(
            os.path.join(d, "data", split), pc.obs_seq_len, pc.pred_seq_len,
            32, cache=False) for split in ("train", "test"))
        windows_s = time.perf_counter() - t_w

        # one Adam step on the card and on the CPU, f32 without TF32
        tree = state_dict_to_tree(init_gst(
            pc, torch.Generator().manual_seed(1000), "cpu").state_dict())
        card_vs_cpu = _gst_card_vs_cpu(
            pc, tree, gst_trainer.stack_windows(train_w[:GST_BATCH]), device)

        untrained = gst_eval.evaluate_dataset(
            load_gst(pc, tree, device), val_w, batch_size=GST_BATCH)
        torch.cuda.synchronize()
        t_t = time.perf_counter()
        out = os.path.join(d, "run")
        _, hist = gst_trainer.train(
            pc, train_w, val_w, out, epochs=GST_EPOCHS, lr=GST_LR,
            batch_size=GST_BATCH, save_epochs=GST_EPOCHS, params=tree,
            device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t_t
        params = os.path.join(out, f"epoch_{GST_EPOCHS}", "params.npz")
        gst = load_gst(cfg.pred, params, device)
        gens = [evaluation.case_generator(cfg.ppo.seed, i) for i in range(16)]
        st, ob = crowd_sim.reset(cfg, gens, device)
        st, ob, rew, _ = pretext_process(cfg, gst, st, ob,
                                         torch.zeros(16, device=device))
        traj, _ = gst_predict(gst, st.traj_buffer[:, ::cfg.pred_interval]
                              .transpose(1, 2),
                              st.mask_buffer[:, ::cfg.pred_interval]
                              .transpose(1, 2))
        pred_finite = bool(torch.isfinite(traj).all()
                           and torch.isfinite(ob.spatial_edges).all()
                           and torch.isfinite(rew).all())
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(train_w) // GST_BATCH
    epochs = [{k: hist[k][e] for k in hist} for e in range(GST_EPOCHS)]
    for e in epochs:
        e["ms_per_train_step"] = 1e3 * e["train_seconds"] / steps
    last = epochs[-1]
    emit("gst_train", t0, nvidia_smi=smi,
         records={"train": sum(len(r) for r in train_rows),
                  "val": sum(len(r) for r in val_rows)},
         envs={"train": GST_TRAIN_ENVS, "val": GST_VAL_ENVS},
         collect_steps=GST_STEPS, collect_seconds=collect_s,
         windows={"train": len(train_w), "val": len(val_w)},
         windows_seconds=windows_s, batch=GST_BATCH,
         train_steps_per_epoch=steps,
         card_vs_cpu=card_vs_cpu,
         untrained_val=untrained, epochs=epochs, train_seconds=train_s,
         ms_per_train_step=min(e["ms_per_train_step"] for e in epochs),
         checkpoint=f"epoch_{GST_EPOCHS}/params.npz",
         predictor_finite=pred_finite, launches=launches)
    if not all(math.isfinite(e[k]) for e in epochs for k in
               ("train_loss", "val_loss")):
        fail(f"gst_train: a non-finite loss: {epochs}")
    if not (last["val_aoe"] <= 0.5 * untrained["aoe"]
            and last["val_foe"] <= 0.5 * untrained["foe"]):
        fail(f"gst_train: val aoe/foe {last['val_aoe']}/{last['val_foe']} "
             f"not <= half the untrained {untrained['aoe']}/"
             f"{untrained['foe']}")
    if not pred_finite:
        fail("gst_train: the trained predictor gave a non-finite value")
    if any(attention_counts(launches).values()) or not launches[ORCA]:
        fail(f"gst_train: an attention kernel launched, or the ORCA robot's "
             f"crowds launched no ORCA kernel: {launches}")
    return launches


def phase_edges(device) -> tuple:
    """The edges/s bench at its full shapes, through its own entry points:
    (launch counts, fused_sweep's ms)."""
    t0 = time.perf_counter()
    zero_counts()
    torch.cuda.synchronize()
    rates = bench_edges.single_device(device=device)
    sweep = bench_edges.fused_sweep(device=device)
    torch.cuda.synchronize()
    launches = read_counts()
    calls = bench_edges.ITERS + 1                     # a warm-up, then ITERS
    expect = {"K1_fused_graph_attention": len(bench_edges.SWEEP_ROWS) * calls,
              "K2_fused_graph_attention_backward": 0,
              "K3_packed_masked_attention": calls}
    emit("edges", t0, single_device_edges_per_s=rates,
         single_device_g_edges_per_s={k: v / 1e9 for k, v in rates.items()},
         fused_sweep_ms=sweep, launches=launches)
    values = list(rates.values()) + [t for row in sweep.values()
                                     for t in row.values()]
    if not all(math.isfinite(v) and v > 0 for v in values):
        fail(f"edges: a rate or time is not finite and positive: {rates}, "
             f"{sweep}")
    if launches != {**expect, ORCA: 0, SPAWN: 0}:
        fail(f"edges launches {launches}, expected {expect} and no ORCA "
             f"or spawn")
    return launches, sweep


def phase_parallel(cfg, gst, device, plain_first) -> dict:
    t0 = time.perf_counter()
    os.makedirs(os.path.join(REPO, ".torch_build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(REPO, ".torch_build")) as tmp:
        launch.initialize(num_processes=1, process_id=0, device=device,
                          init_method=f"file://{tmp}/store")
        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"parallel: the process group is {backend}, not nccl")
        mesh = launch.global_mesh(tp=1)
        p = cfg.ppo

        # the train phase's warm start through the data-parallel iteration
        ts = launch.init_sharded_global(
            cfg, mesh, gst, device,
            pmod.load_policy(cfg, DEFAULT_PARAMS, device))
        iteration = launch.make_global_iteration(cfg, mesh, gst)
        zero_counts()
        torch.cuda.synchronize()
        t_it = time.perf_counter()
        ts, m = iteration(ts)
        torch.cuda.synchronize()
        iter_s = time.perf_counter() - t_it
        launches = read_counts()
        n_updates = p.ppo_epoch * p.num_mini_batch
        expect = {"K1_fused_graph_attention": p.num_steps + 1 + n_updates,
                  "K2_fused_graph_attention_backward": n_updates,
                  "K3_packed_masked_attention": 0}
        if attention_counts(launches) != expect:
            fail(f"parallel launches {launches}, expected {expect}")
        check_orca_launches("parallel", launches[ORCA], orca_solves(
            cfg, "train", "network", p.num_steps, 0))
        want, vl_plain = plain_first
        vl = float(m["value_loss"])
        if not (math.isfinite(vl)
                and abs(vl - vl_plain) <= PARALLEL_RTOL * abs(vl_plain)):
            fail(f"parallel value loss {vl} vs plain {vl_plain}")
        got = full_params(ts.model, mesh)
        param_err = max((got[k] - want[k]).abs().max().item() for k in want)
        if not param_err <= PARALLEL_ATOL:
            fail(f"parallel params differ from the plain iteration's by "
                 f"{param_err}")

        # the ring at world size one against the dense plain math
        rows, a, d, heads = RING_SHAPE
        q, k, v, mask = k3_inputs(rows, a, 0, device, d=d)
        with torch.no_grad():
            ring = edge_partitioned_attention(q, k, v, mask, heads, mesh)
            dense = reference_masked_attention(q, k, v, mask, heads)
            ring_err = (ring - dense).abs().max().item()
            ring_ms = time_ms(lambda: edge_partitioned_attention(
                q, k, v, mask, heads, mesh))
            dense_ms = time_ms(lambda: reference_masked_attention(
                q, k, v, mask, heads))
        if not ring_err <= RING_ATOL:
            fail(f"ring attention vs the dense math: {ring_err}")

        t_ws = time.perf_counter()
        weak = bench_edges.weak_scaling(device=device)
        weak_train = bench_edges.weak_scaling_train(device=device)
        weak_s = time.perf_counter() - t_ws
        values = [r[key] for res, key in ((weak, "edges_per_s"),
                                          (weak_train, "env_steps_per_s"))
                  for r in res.values()]
        if not (list(weak) == list(weak_train) == [1] and
                all(math.isfinite(x) and x > 0 for x in values)):
            fail(f"weak scaling: {weak}, {weak_train}")
        launch.finalize()
    emit("parallel", t0, backend=backend, world_size=1, mesh=mesh.shape,
         envs=p.num_processes, steps=p.num_steps, iteration_seconds=iter_s,
         launches=launches, value_loss=vl, value_loss_plain=vl_plain,
         param_max_abs_err_vs_plain=param_err,
         done_count=int(m["done_count"]),
         ring={"rows": rows, "A": a, "D": d, "heads": heads,
               "max_abs_err_vs_dense": ring_err, "ms": ring_ms,
               "dense_ms": dense_ms},
         weak_scaling=weak, weak_scaling_train=weak_train,
         weak_scaling_seconds=weak_s)
    return launches


def _policy_batch(obs: dict, device) -> dict:
    """A gym observation (numpy, no batch axis) as the policy's batch of
    one on ``device``."""
    return {k: torch.as_tensor(v, device=device)[None]
            if k != "detected_human_num" else
            torch.as_tensor(v, device=device).long() for k, v in obs.items()}


def _off_native(cfg, device, rollout) -> dict:
    """The native engine built with g++, and the humans' ORCA velocities of
    the flagship state (64 envs x 20 humans after 5 steps) three ways: the
    batched ORCA on the card in f32 and in f64, the engine on the host, the
    NumPy oracle on the first ORACLE_EGOS egos; then the 8-agent antipodal
    circle through 60 engine crowd steps."""
    t = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t
    st = rollout["state"]
    nbr_pos, nbr_vel, nbr_radius, nbr_mask, _ = \
        crowd_sim.build_human_neighbor_inputs(cfg, st)
    B, A, N = nbr_mask.shape
    E = B * A
    inflate = crowd_sim._inflate(cfg)
    h = st.humans
    args = [h.pos.reshape(E, 2), h.vel.reshape(E, 2),
            (h.radius + inflate).reshape(E), h.v_pref.reshape(E),
            crowd_sim._pref_velocity(h.goal, h.pos).reshape(E, 2),
            nbr_pos.reshape(E, N, 2), nbr_vel.reshape(E, N, 2),
            (nbr_radius + inflate).reshape(E, N), nbr_mask.reshape(E, N)]
    nd = st.orca_neighbor_dist[:, None].expand(B, A).reshape(E)
    ts, th = cfg.env.time_step, cfg.orca.time_horizon
    f32 = orca_velocity_batch(*args, ts, th, nd)
    a64 = [x.double() if x.is_floating_point() else x for x in args]
    f64 = orca_velocity_batch(*a64, ts, th, nd.double())
    d, p, valid = orca_lines(args[0], args[1], args[2], args[5], args[6],
                             args[7], args[8], ts, th, nd)
    _, lp2_fail = _lp2(d, p, valid, args[3], args[4], False)
    host = [x.cpu().numpy() for x in a64]
    nd_h = nd.double().cpu().numpy()
    t = time.perf_counter()
    eng = np.stack([native.orca_velocity_native(
        *[x[e] for x in host], ts, th, nd_h[e]) for e in range(E)])
    engine_s = time.perf_counter() - t
    t = time.perf_counter()
    oracle = np.stack([orca_velocity_np(
        *[x[e] for x in host[:5]], *[x[e][host[8][e]] for x in host[5:8]],
        ts, th, nd_h[e]) for e in range(ORACLE_EGOS)])
    oracle_s = time.perf_counter() - t
    f32, f64 = f32.cpu().numpy(), f64.cpu().numpy()
    lp2_ok = lp2_fail.cpu().numpy() == N
    err32 = np.abs(f32 - eng).max(-1)
    err64 = np.abs(f64 - eng).max(-1)
    err_oracle = np.abs(eng[:ORACLE_EGOS] - oracle).max()
    off = (~lp2_ok & (err32 > ORCA_F32_LP3)).reshape(B, A).sum(-1)
    lp3 = (~lp2_ok).reshape(B, A).sum(-1)
    flips_ok = bool(np.all(off <= np.maximum(1, 0.03 * lp3)))

    # the crowd stepper: 8 agents swapping places across a circle
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pos = np.stack([5 * np.cos(ang), 5 * np.sin(ang)], axis=1)
    goal, vel = -pos.copy(), np.zeros((8, 2))
    d0, min_gap = np.linalg.norm(pos - goal, axis=1), np.inf
    for _ in range(60):
        pos, vel = native.orca_crowd_step_native(
            pos, vel, np.full(8, 0.3), np.ones(8), goal, 0.15, ts, th, 10.0)
        gap = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        min_gap = min(min_gap, float(gap[np.triu_indices(8, 1)].min()))
    progressed = bool(np.all(np.linalg.norm(pos - goal, axis=1) < d0))
    info = {"library": os.path.basename(native.library_path()),
            "build_seconds": build_s, "egos": E, "neighbours": N,
            "lp3_egos": int((~lp2_ok).sum()),
            "f32_max_abs_err_lp2": float(err32[lp2_ok].max()),
            "f32_max_abs_err_lp3": float(err32[~lp2_ok].max())
            if (~lp2_ok).any() else 0.0,
            "f32_lp3_flips": int(off.sum()),
            "f64_max_abs_err": float(err64.max()),
            "oracle_egos": ORACLE_EGOS,
            "engine_vs_oracle_max_abs_err": float(err_oracle),
            "engine_seconds": engine_s, "oracle_seconds": oracle_s,
            "crowd_step_min_gap": min_gap, "crowd_step_progressed": progressed}
    if not (info["f32_max_abs_err_lp2"] <= ORCA_F32_LP2 and flips_ok
            and info["f64_max_abs_err"] <= ORCA_F64
            and err_oracle <= ORCA_ORACLE):
        fail(f"off_path native: ORCA cross-check out of bounds: {info}")
    if not (min_gap > 0.55 and progressed):
        fail(f"off_path native: crowd step: {info}")
    return info


def _lidar_bound(cfg, args) -> tuple:
    """The scan in float64 on the CPU, and its per-ray bound: LIDAR_ATOL,
    plus on a hit four float32 ulps of |rel|^2 over the sqrt argument (the
    range cancels |rel|^2 - t^2; tests/test_torch_lidar.py)."""
    rp, th, hp, hr, hm = (a.double().cpu() for a in args)
    R = lidar.num_rays(cfg)
    ang = th[..., None] + torch.arange(R, dtype=torch.float64) * (
        2 * math.pi / R)
    dvec = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    rel = hp - rp[..., None, :]
    tt = torch.einsum("...rk,...ak->...ra", dvec, rel)
    c2 = (rel * rel).sum(-1)[..., None, :].expand_as(tt)
    arg = (hr * hr)[..., None, :] - (c2 - tt * tt)
    hit_t = tt - torch.sqrt(arg.clamp_min(0.0))
    valid = (arg >= 0) & (hit_t > 0) & (hm[..., None, :] > 0)
    ranges = torch.where(valid, hit_t, torch.full_like(hit_t, cfg.lidar.range))
    near = ranges.argmin(-1, keepdim=True)
    out = ranges.gather(-1, near)[..., 0].clamp_max(cfg.lidar.range)
    hit = out < cfg.lidar.range
    cond = (c2.gather(-1, near)[..., 0]
            / arg.gather(-1, near)[..., 0].clamp_min(1e-12).sqrt())
    eps = torch.finfo(torch.float32).eps
    return out, LIDAR_ATOL + torch.where(hit, 4 * eps * cond,
                                         torch.zeros_like(cond))


def _off_lidar(cfg, device, rollout) -> dict:
    """``lidar.scan`` at 64 envs x 72 rays x 20 humans on the card against
    the same call on the CPU (and both against the float64 scan)."""
    st = rollout["state"]
    active = torch.arange(cfg.sim.max_human_num, device=device)[None] < \
        st.human_num[:, None]
    args = (st.robot.pos, st.robot.theta, st.humans.pos, st.humans.radius,
            active.float())
    card = lidar.scan(cfg, *args)
    cpu = lidar.scan(cfg, *(a.cpu() for a in args))
    card = card.cpu()
    truth, bound = _lidar_bound(cfg, args)
    err = (card - cpu).abs()
    miss = truth == cfg.lidar.range
    info = {"shape": list(card.shape), "rays_hit": int((~miss).sum()),
            "max_abs_err_vs_cpu": err.max().item(),
            "max_abs_err_vs_cpu_misses": err[miss].max().item()
            if miss.any() else 0.0,
            "rays_over_flat_atol": int((err > LIDAR_ATOL).sum()),
            "max_abs_err_vs_f64": (card.double() - truth).abs().max().item()}
    if not (card.shape == (64, lidar.num_rays(cfg)) and bool(
            (err.double() <= bound).all()) and bool(
            ((card.double() - truth).abs() <= bound).all())
            and info["max_abs_err_vs_cpu_misses"] <= LIDAR_ATOL):
        fail(f"off_path lidar: {info}")
    return info


def _off_gym(policy, pcfg, device) -> tuple:
    """The flagship env through the gym adapter (the committed GST export),
    stepped by the committed policy's deterministic action; then the
    var-num env with the scripted ORCA robot, which launches no kernel."""
    env = gym_adapter.make("CrowdSimPredRealGST-v0",
                           gst_params=DEFAULT_GST_PARAMS, device=device)
    obs, _ = env.reset(seed=0)
    hxs = init_hidden(pcfg, 1, device)
    masks = torch.ones(1, device=device)
    acts, rewards, shapes = 0, [], set()
    for _ in range(GYM_STEPS):
        _, action, _, hxs = pmod.act(policy, _policy_batch(obs, device), hxs,
                                     masks)
        acts += 1
        obs, r, term, trunc, _ = env.step(action[0].cpu().numpy())
        rewards.append(r)
        shapes.add(obs["spatial_edges"].shape)
        if term or trunc:
            break
    zero_before = read_counts()
    orca_env = gym_adapter.make("CrowdSimVarNum-v0", robot_policy="orca",
                                device=device)
    orca_env.reset(seed=0)
    orca_steps = 0
    for _ in range(GYM_STEPS):
        _, r2, term, trunc, _ = orca_env.step(np.zeros(2))
        orca_steps += 1
        if not math.isfinite(r2) or term or trunc:
            break
    scripted_launches = {k: read_counts()[k] - v
                         for k, v in attention_counts(zero_before).items()}
    info = {"gst_steps": acts, "gst_rewards": rewards,
            "spatial_edges_shapes": sorted(shapes),
            "orca_steps": orca_steps, "orca_launches": scripted_launches}
    if not (all(math.isfinite(r) for r in rewards) and shapes == {(20, 12)}
            and math.isfinite(r2) and not any(scripted_launches.values())):
        fail(f"off_path gym: {info}")
    return info, acts, env


def _off_record_replay(cfg, policy, gst, device) -> tuple:
    """record_sim_episode with the network policy (case 0, at most
    RECORD_STEPS steps), the CSVs saved and the actions replayed on the
    card: the positions must equal the recording bit for bit. Then
    record_episode of the same case (no drawing), cut by the time limit at
    RECORD_EPISODE_STEPS + 1 steps: its positions must equal the
    recording's too."""
    with tempfile.TemporaryDirectory() as tmp:
        _, steps = sim2real.record_sim_episode(
            cfg, case_idx=0, robot_policy="network", policy=policy,
            gst_model=gst, out_dir=tmp, max_steps=RECORD_STEPS,
            device=device)
        actions = Recorder.load_actions(os.path.join(tmp, "0_actions.csv"))
        with open(os.path.join(tmp, "0_positions.csv")) as f:
            recorded = np.asarray([[float(x) for x in row]
                                   for row in csv.reader(f)], np.float32)
    replayed = sim2real.replay_actions(cfg, actions, case_idx=0,
                                       device=device).astype(np.float32)
    # the same case through record_episode, its episode cut at
    # RECORD_EPISODE_STEPS by the time limit (the dynamics do not read it)
    short = cfg.replace(env=dataclasses.replace(
        cfg.env, time_limit=1.0 + RECORD_EPISODE_STEPS * cfg.env.time_step))
    traj = render.record_episode(short, policy, gst, case_idx=0,
                                 base_seed=cfg.ppo.seed,
                                 robot_policy="network", device=device)
    traj_pos = np.asarray(traj["robot_pos"][1:steps + 1], np.float32)
    n = min(len(traj_pos), steps)
    info = {"recorded_steps": steps, "replayed_steps": len(replayed),
            "replay_bit_equal": bool(np.array_equal(replayed, recorded)),
            "replay_max_abs_err": float(np.abs(replayed - recorded).max())
            if replayed.shape == recorded.shape else None,
            "record_episode_steps": len(traj["robot_pos"]),
            "record_episode_bit_equal": bool(np.array_equal(
                traj_pos[:n], recorded[:n]))}
    if not (steps > 0 and info["replay_bit_equal"]
            and info["record_episode_bit_equal"]):
        fail(f"off_path record_replay: {info}")
    return info, steps + len(traj["robot_pos"])


def _off_sim2real(cfg, policy, device) -> tuple:
    """Sim2RealEnv over DummyDetectionSource (seed 0) fed to the committed
    policy on the card for SIM2REAL_STEPS steps; the observation contract's
    shapes and dtypes."""
    env = sim2real.Sim2RealEnv(cfg, sim2real.DummyDetectionSource(cfg, 0))
    A, D = cfg.sim.max_human_num, cfg.spatial_edge_dim
    want = {"robot_node": ((1, 7), np.float32),
            "temporal_edges": ((1, 2), np.float32),
            "spatial_edges": ((A, D), np.float32),
            "visible_masks": ((A,), np.bool_),
            "detected_human_num": ((1,), np.float32)}
    ob = env.reset()
    hxs = init_hidden(cfg, 1, device)
    masks = torch.ones(1, device=device)
    contract, cmds = True, []
    for _ in range(SIM2REAL_STEPS):
        contract &= all(ob[k].shape == s and ob[k].dtype == dt
                        for k, (s, dt) in want.items())
        _, action, _, hxs = pmod.act(policy, sim2real.policy_obs(ob, device),
                                     hxs, masks)
        ob, _, _, step_info = env.step(action[0].cpu().numpy())
        cmds.append([step_info["v"], step_info["w"]])
    info = {"steps": SIM2REAL_STEPS, "contract_ok": contract,
            "last_cmd": cmds[-1]}
    if not (contract and np.all(np.isfinite(cmds))):
        fail(f"off_path sim2real: {info}")
    return info, SIM2REAL_STEPS


def _off_rms_profiling(device, rollout, env) -> dict:
    """rms_update / normalize_obs over the rollout's robot_node batch on
    the card against the CPU; one gym step under profiling.trace. The
    state is held to RMS_TOL relative; a normalized entry to RMS_TOL
    relative plus four float32 ulps of |x| + |mean| over the std: the
    radius and v_pref columns are constant, so x - mean is rounding noise
    that the 1e-4 std of eps = 1e-8 amplifies 1e4 times."""
    batch = rollout["robot_node"]
    card = rms.rms_update(rms.rms_init((7,), device), batch)
    x = batch.cpu()
    cpu = rms.rms_update(rms.rms_init((7,)), x)
    norm_card = rms.normalize_obs(card, batch).cpu()
    norm_cpu = rms.normalize_obs(cpu, x)
    state_err = max(((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max().item()
                    for a, b in zip(card, cpu))
    eps = torch.finfo(torch.float32).eps
    norm_bound = (RMS_TOL * norm_cpu.abs().clamp_min(1.0) + 4 * eps
                  * (x.abs() + cpu.mean.abs()) / torch.sqrt(cpu.var + 1e-8))
    norm_err = (norm_card - norm_cpu).abs()
    env.reset(seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            env.step(np.array([0.3, 0.1]))
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    cuda_events = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      for e in prof.events())
    info = {"rows": int(batch.shape[0]), "state_max_rel_err": state_err,
            "normalized_max_abs_err": norm_err.max().item(),
            "normalized_within_bound": bool((norm_err <= norm_bound).all()),
            "trace_cuda_events": cuda_events, "trace_bytes": trace_bytes}
    if not (state_err <= RMS_TOL and info["normalized_within_bound"]
            and cuda_events > 0):
        fail(f"off_path rms/profiling: {info}")
    return info


def phase_off_path(cfg, gst, device) -> dict:
    """The modules off the training path: the native ORCA engine, lidar,
    the gym adapter, record and replay, sim2real, running mean/std and
    profiling, each part timed with ``profiling.PhaseTimer`` and its launch
    counts zeroed just before and read just after. K1 must launch once per
    policy ``act`` (gym, record_replay, sim2real), K2 and K3 never. Nothing
    here draws: ``record_episode`` runs, ``render_*`` and ``plot`` do not
    (the card's machine has no matplotlib)."""
    t0 = time.perf_counter()
    timer = profiling.PhaseTimer()
    policy = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    parts, acts, total = {}, {}, {}
    # the flagship state: 64 envs x 20 ORCA humans, 5 train-phase steps
    with timer.phase("rollout", sync=device):
        gens = [evaluation.case_generator(cfg.ppo.seed, i, "train")
                for i in range(cfg.ppo.num_processes)]
        st, ob = crowd_sim.reset(cfg, gens, device)
        nodes = [ob.robot_node]
        zero = torch.zeros(len(gens), 2, device=device)
        for _ in range(5):
            st, ob, _, _, _ = crowd_sim.step(cfg, st, zero, "train")
            nodes.append(ob.robot_node)
        rollout = {"state": st, "robot_node": torch.cat(nodes)}
    env_holder = {}

    def run(name, fn):
        zero_counts()
        with timer.phase(name, sync=device):
            out = fn()
        launches = read_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        info, n_act = out if isinstance(out, tuple) else (out, 0)
        parts[name] = {**info, "launches": launches}
        print(json.dumps({"off_path_part": name,
                          "seconds": timer.totals[name], **parts[name]}),
              file=sys.stderr, flush=True)
        acts[name] = n_act
        return launches

    run("native", lambda: _off_native(cfg, device, rollout))
    run("lidar", lambda: _off_lidar(cfg, device, rollout))

    def gym():
        info, n, env = _off_gym(policy, cfg, device)
        env_holder["env"] = env
        return info, n
    run("gym", gym)
    run("record_replay", lambda: _off_record_replay(cfg, policy, gst, device))
    run("sim2real", lambda: _off_sim2real(cfg, policy, device))
    run("rms_profiling",
        lambda: _off_rms_profiling(device, rollout, env_holder["env"]))
    n_acts = sum(acts.values())
    k1_by_part = {k: v["launches"]["K1_fused_graph_attention"]
                  for k, v in parts.items()}
    emit("off_path", t0, parts=parts, part_seconds=dict(timer.totals),
         policy_acts=acts, launches=total)
    if k1_by_part != acts:
        fail(f"off_path: K1 launches by part {k1_by_part} != policy acts "
             f"{acts} ({n_acts} in all)")
    if total["K2_fused_graph_attention_backward"] or \
            total["K3_packed_masked_attention"]:
        fail(f"off_path: K2 or K3 launched: {total}")
    return total


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    names = [masked_attention.KERNEL, masked_attention.KERNEL_BWD,
             masked_attention.KERNEL_ATTN, orca.KERNEL, spawn.KERNEL]
    reports = _build.build(names)
    ptxas = {k: ptxas_summary(v) for k, v in reports.items()}
    emit("build", t0, kernels=names, ptxas=ptxas)

    t0 = time.perf_counter()
    # the paths' shapes: evaluation (32 cases; A = 5 and 10 in
    # variants_eval), rollout act/get_value (64 envs) and the update's
    # minibatch (30 steps x 32 envs)
    k1 = {rows: check_k1(rows, device) for rows in K1_ROWS}
    k1_wide = check_k1(960, device, A_WIDE)
    k1_wide64 = check_k1(64, device, A_WIDE)      # config 5's rollout
    k1_past = check_k1(960, device, A_PAST)
    k1_variants = {a: check_k1(N_CASES, device, a) for a in A_VARIANTS}
    k1_edges = check_k1_edges(device)
    k2 = check_k2(960, device)
    k2_wide = check_k2(960, device, A_WIDE)
    k2_past = check_k2(960, device, A_PAST)
    # the scattered masks of sort_humans=False at the rollout's and the
    # update's rows
    k1_scattered = {rows: check_k1(rows, device, scattered=True)
                    for rows in SCATTERED_ROWS}
    k2_scattered = {rows: check_k2(rows, device, scattered=True)
                    for rows in SCATTERED_ROWS}
    k3 = [check_k3(rows, a, heads, dt, device, stream=(i == 0))
          for i, (rows, a, heads, dt) in enumerate(K3_CASES)]
    # what the kernels take since their shape limits went
    k1_any = [check_k1(rows, device, a, d, heads, reps=REPS_ANY[rows, a])
              for rows, a, d, heads in ANY_K12]
    k2_any = [check_k2(rows, device, a, d, heads, reps=REPS_ANY[rows, a])
              for rows, a, d, heads in ANY_K12]
    k3_any = [check_k3(rows, a, heads, torch.float32, device, d=d)
              for rows, a, d, heads in ANY_K3]
    # the device kernels behind one wrapper call, at the entries' shapes
    k1_args = k1_inputs(N_CASES, seed=0, device=device)
    k2_args = k1_inputs(960, seed=0, device=device)[:5] + [
        torch.randn(960, A, D, device=device)]
    q, k, v, mask = k3_inputs(*K3_CASES[0][:2], 0, device)
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    dev_kernels = {
        "K1_fused_graph_attention": {tag: device_kernels(
            lambda: fused_graph_attention(*k1_args, HEADS, compute_dtype=dt))
            for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
        "K2_fused_graph_attention_backward": {tag: device_kernels(
            lambda: fused_graph_attention_backward(*k2_args, HEADS,
                                                   compute_dtype=dt))
            for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
        "K3_packed_masked_attention": {
            "f32": device_kernels(
                lambda: packed_masked_attention(q, k, v, mask, HEADS)),
            "bf16": device_kernels(
                lambda: packed_masked_attention(q16, k16, v16, mask, HEADS))},
    }
    emit("kernels", t0, k1=k1, k1_a50=k1_wide, k1_rows64_a50=k1_wide64,
         k1_a80=k1_past, k1_variants=k1_variants,
         k1_edges=k1_edges, k2=k2, k2_a50=k2_wide, k2_a80=k2_past,
         k1_scattered=k1_scattered, k2_scattered=k2_scattered, k3=k3,
         k1_any_shape=k1_any, k2_any_shape=k2_any, k3_any_shape=k3_any,
         device_kernels=dev_kernels)

    orca_shapes = phase_orca(device)
    spawn_shapes = phase_spawn(device)

    cfg = config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    eval_launches = phase_evaluate(cfg, gst, device)
    train_launches, train_first = phase_train(cfg, gst, device)
    edges_launches, edges_sweep = phase_edges(device)
    path_launches = {"evaluate": eval_launches, "train": train_launches,
                     "edges": edges_launches,
                     "scripted": phase_scripted(device),
                     "variants_eval": phase_variants_eval(device),
                     "variants_train": phase_variants_train(device),
                     "unicycle_train": phase_unicycle_train(gst, device),
                     "policy_variants": phase_policy_variants(gst, device),
                     "gst_train": phase_gst_train(cfg, device, smi),
                     "parallel": phase_parallel(cfg, gst, device,
                                                train_first),
                     "off_path": phase_off_path(cfg, gst, device)}

    def per_call(name):
        return {"device_launches_per_call": {
                    tag: None if names is None else len(names)
                    for tag, names in dev_kernels[name].items()},
                "device_kernels": dev_kernels[name]}

    def entry(name, source, replaces, m, shape):
        by_path = {p: path_launches[p][name] for p in path_launches}
        return {
            "name": name, "route": "cuda",
            "source": f"crowdnav_prediction_attngraph_tpu_torch/ops/csrc/"
                      f"{source}",
            "replaces": f"crowdnav_prediction_attngraph_tpu/ops/"
                        f"masked_attention.py:{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": {**shape, "A": A, "D": D, "heads": HEADS,
                      "dtype": "bf16"},
            "max_abs_err": m["max_abs_err_bf16"], "ms": m["kernel_ms_bf16"],
            "plain_ms": m["plain_ms_bf16"], "bound_ms": m["bound_ms_bf16"],
            "bound_by": m["bound_by_bf16"],
            "library_ms": m["library_ms_bf16"],
            "f32": {k[:-4]: v for k, v in m.items() if k.endswith("_f32")},
            **per_call(name),
            "ptxas": ptxas.get(source[:-3], {}),
        }
    k1_entry = entry("K1_fused_graph_attention", "fused_graph_attention.cu",
                     175, k1[N_CASES], {"rows": N_CASES})
    for rows in K1_ROWS[1:]:
        k1_entry[f"rows{rows}"] = k1[rows]
    k1_entry[f"rows960_a{A_WIDE}"] = k1_wide
    k1_entry[f"rows64_a{A_WIDE}"] = k1_wide64
    k1_entry[f"rows960_a{A_PAST}"] = k1_past
    for a, m in k1_variants.items():
        k1_entry[f"rows{N_CASES}_a{a}"] = m
    for rows, m in k1_scattered.items():
        k1_entry[f"rows{rows}_scattered_mask"] = m
    k1_entry["edges_max_abs_err_bf16"] = {r: e["max_abs_err"]
                                          for r, e in k1_edges.items()}
    k1_entry["edges_sweep_rows"] = k1_edges
    k1_entry["edges_fused_sweep_ms"] = edges_sweep
    k1_entry["any_shape"] = k1_any
    k2_entry = entry("K2_fused_graph_attention_backward",
                     "fused_graph_attention_bwd.cu", 298, k2, {"rows": 960})
    k2_entry["max_abs_err_by_grad_bf16"] = k2["max_abs_err_by_grad_bf16"]
    k2_entry[f"rows960_a{A_WIDE}"] = k2_wide
    k2_entry[f"rows960_a{A_PAST}"] = k2_past
    k2_entry["any_shape"] = k2_any
    for rows, m in k2_scattered.items():
        k2_entry[f"rows{rows}_scattered_mask"] = m
    k3_by_path = {p: path_launches[p]["K3_packed_masked_attention"]
                  for p in path_launches}
    k3_entry = {
        "name": "K3_packed_masked_attention", "route": "cuda",
        "source": "crowdnav_prediction_attngraph_tpu_torch/ops/csrc/"
                  "packed_masked_attention.cu",
        "replaces": "crowdnav_prediction_attngraph_tpu/ops/"
                    "masked_attention.py:50",
        "launches": sum(k3_by_path.values()), "launches_by_path": k3_by_path,
        "shape": {"rows": K3_CASES[0][0], "A": K3_CASES[0][1], "D": D,
                  "heads": HEADS, "dtype": "f32"},
        **{key: k3[0][key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_max_abs_err", "stream_ms",
                                       "bound_frac", "valid_keys_per_row",
                                       "bound_ms_all_keys",
                                       "bitwise_second_run")},
        "max_abs_err_by_shape": {
            f"rows{r['rows']}_a{r['A']}_h{r['heads']}_{r['dtype']}":
            r["max_abs_err"] for r in k3},
        "by_shape": k3[1:], "any_shape": k3_any,
        **per_call("K3_packed_masked_attention"),
        "ptxas": ptxas.get(masked_attention.KERNEL_ATTN, {}),
    }
    orca_by_path = {p: path_launches[p][ORCA] for p in path_launches}
    orca_entry = {
        "name": ORCA, "route": "cuda",
        "source": "crowdnav_prediction_attngraph_tpu_torch/ops/csrc/"
                  "orca_solve.cu",
        "replaces": None,
        "launches": sum(orca_by_path.values()),
        "launches_by_path": orca_by_path,
        "shape": {"egos": SCENE_SHAPES[0][0], "lines": SCENE_SHAPES[0][1],
                  "dtype": "f32"},
        **{key: orca_shapes[0][key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "lp3_egos")},
        "by_shape": orca_shapes,
        "ptxas": ptxas.get(orca.KERNEL, {}),
    }
    spawn_by_path = {p: path_launches[p][SPAWN] for p in path_launches}
    spawn_entry = {
        "name": SPAWN, "route": "cuda",
        "source": "crowdnav_prediction_attngraph_tpu_torch/ops/csrc/"
                  "human_spawn.cu",
        "replaces": None,
        "launches": sum(spawn_by_path.values()),
        "launches_by_path": spawn_by_path,
        "shape": {k: spawn_shapes[0][k] for k in ("entry", "envs", "slots")},
        **{key: spawn_shapes[0][key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "by_shape": spawn_shapes,
        "ptxas": ptxas.get(spawn.KERNEL, {}),
    }
    print(json.dumps({"kernels": [k1_entry, k2_entry, k3_entry,
                                  orca_entry, spawn_entry]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
