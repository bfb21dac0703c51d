"""Typed, hashable configuration for the PyTorch port.

A copy of ``crowdnav_prediction_attngraph_tpu/config.py`` (the frozen
dataclasses and the ``varnum_config`` / ``pred_config`` / ``gst_config``
builders) that imports nothing of the JAX package: importing that module runs
the JAX package's ``__init__``, which imports jax. Field defaults and derived
quantities are identical; ``build_config`` is the JAX package's
``train.py:43-85`` CLI builder, shared by the port's ``train`` and ``test``,
and ``config_from_snapshot`` its ``test.py:41-60`` loader for a run's
``config.json``.

Reference field provenance is cited inline as ``file:line`` into the upstream
CrowdNav++ sources.
"""

from __future__ import annotations

import dataclasses
import json
import math


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class EnvConfig:
    """General env knobs (reference config.py:17-27)."""

    time_limit: float = 50.0          # config.py:18
    time_step: float = 0.25           # config.py:19
    val_size: int = 100               # config.py:20
    test_size: int = 500              # config.py:21
    randomize_attributes: bool = True  # config.py:23


@_frozen
class RewardConfig:
    """Reward shaping (reference config.py:30-36)."""

    success_reward: float = 10.0          # config.py:31
    collision_penalty: float = -20.0      # config.py:32
    discomfort_dist: float = 0.25         # config.py:34
    discomfort_penalty_factor: float = 10.0  # config.py:35
    gamma: float = 0.99                   # config.py:36
    # unicycle spin penalty -c * r^2 (crowd_sim_var_num.py:551, c = 4.5).
    # With warmup > 0 the TRAINING rollout anneals c linearly from 0 over
    # the first `spin_penalty_warmup_steps` env steps — the full-strength
    # penalty dominates early exploration and freezes turning before
    # collision avoidance can be learned (r4 unicycle NOTES.md); eval and
    # the non-warmup path apply the constant reference coefficient.
    spin_penalty_factor: float = 4.5
    spin_penalty_warmup_steps: int = 0


@_frozen
class SimConfig:
    """Simulation layout (reference config.py:39-52)."""

    circle_radius: float = 6.0 * math.sqrt(2.0)  # config.py:40
    arena_size: float = 6.0                      # config.py:41
    human_num: int = 20                          # config.py:42
    human_num_range: int = 0                     # config.py:44
    predict_steps: int = 5                       # config.py:45
    # 'none' | 'const_vel' | 'truth' | 'inferred'  (config.py:46-50)
    predict_method: str = "inferred"

    @property
    def max_human_num(self) -> int:
        # crowd_sim.py:160
        return self.human_num + self.human_num_range

    @property
    def min_human_num(self) -> int:
        # crowd_sim.py:161
        return self.human_num - self.human_num_range


@_frozen
class HumansConfig:
    """Human agent attributes/behaviors (reference config.py:67-94)."""

    visible: bool = True              # config.py:68
    policy: str = "orca"              # config.py:70 ('orca' | 'social_force')
    radius: float = 0.3               # config.py:71
    v_pref: float = 1.0               # config.py:72
    fov: float = 2.0                  # in units of pi (config.py:75)
    random_goal_changing: bool = True    # config.py:79
    goal_change_chance: float = 0.5      # config.py:80
    end_goal_changing: bool = True       # config.py:83
    end_goal_change_chance: float = 1.0  # config.py:84
    random_radii: bool = False           # config.py:87
    random_v_pref: bool = False          # config.py:88


@_frozen
class RobotConfig:
    """Robot attributes (reference config.py:97-108)."""

    visible: bool = False             # config.py:99
    policy: str = "selfAttn_merge_srnn"  # config.py:101
    radius: float = 0.3               # config.py:102
    v_pref: float = 1.0               # config.py:103
    fov: float = 2.0                  # units of pi (config.py:106)
    sensor_range: float = 5.0         # config.py:108


@_frozen
class ActionSpaceConfig:
    kinematics: str = "holonomic"     # 'holonomic' | 'unicycle' (config.py:113)


@_frozen
class OrcaConfig:
    """ORCA crowd-engine parameters (reference config.py:116-120).

    ``neighbor_dist`` is nominally 10 but the reference resamples it U(5, 10)
    per created agent when randomize_attributes is on (agent.py:21-22); we model
    that as a per-episode scalar sampled at reset.
    """

    neighbor_dist: float = 10.0       # config.py:117
    safety_space: float = 0.15        # config.py:118
    time_horizon: float = 5.0         # config.py:119
    time_horizon_obst: float = 5.0    # config.py:120
    # ego agents assume all neighbors cap speed at this (orca.py:59)
    max_neighbor_speed: float = 1.0
    # Reference-artifact emulation (diagnostic): the reference ORCA policy
    # reuses its RVO2 sim across episodes (orca.py:80-82 only rebuilds when the
    # agent count changes), so with randomized attributes the robot plans every
    # episode with episode-1's STALE neighbor radii. True = draw fixed
    # U(0.3, 0.5) radii (keyed per slot, constant across the suite) instead of
    # the current beliefs, to quantify how much of the reference's higher
    # collision rate that staleness explains.
    stale_neighbor_radii: bool = False
    # JAX-package switch for its batch-level lazy LP3; the port always
    # batches ORCA over every ego and runs LP3 only on the egos that need it
    # (env/orca.py), so this field is read but has no effect here.
    lazy_lp3: bool = False


@_frozen
class SocialForceConfig:
    """Social-force crowd engine (reference config.py:123-126)."""

    A: float = 2.0                    # config.py:124
    B: float = 1.0                    # config.py:125
    KI: float = 1.0                   # config.py:126


@_frozen
class LidarConfig:
    """Lidar sensor (reference config.py:145-150).

    In the reference this group is declared but never consumed by any shipped
    env (only the ROS env mentions the lidar frame in a comment); here it
    parameterizes the optional ``env.lidar.scan`` ray-cast observation op.
    """

    angular_res: float = 5.0          # config.py:148 (degrees between rays)
    range: float = 10.0               # config.py:150 (meters)


@_frozen
class DataConfig:
    """GST data collection (reference config.py:129-137)."""

    tot_steps: int = 40000            # config.py:130
    num_processes: int = 5            # config.py:133
    data_save_dir: str = "data/orca_20humans"
    pred_timestep: float = 0.25       # config.py:137


@_frozen
class PredConfig:
    """GST predictor wiring (reference config.py:139-143 + gst args.pickle).

    Shipped checkpoint hyperparameters (SURVEY.md section 2.6): obs_seq_len=5,
    pred_seq_len=5, faster_lstm, embedding 64, 1 spatial layer, 8 node heads,
    0 edge heads (full connectivity), init_temp 0.5 annealed to 0.03, no ghost.
    """

    model_dir: str = ""
    obs_seq_len: int = 5
    pred_seq_len: int = 5
    motion_dim: int = 2
    output_dim: int = 5
    embedding_size: int = 64
    spatial_num_heads: int = 8
    spatial_num_heads_edges: int = 0   # 0 => full connectivity
    spatial_num_layers: int = 1
    lstm_hidden_size: int = 64
    lstm_num_layers: int = 1
    dim_feedforward: int = 128
    ghost: bool = False
    only_observe_full_period: bool = False
    detach_sample: bool = False
    tau: float = 0.03                  # post-annealing temperature (vec_pretext_normalize.py:52-53)
    invalid_value: float = -999.0      # crowd_nav_interface_parallel.py:72
    # matmul compute dtype for inference ("bf16" | "f32"): bf16 rounds the
    # spatial-attention/LSTM/FFN matmul inputs and accumulates in f32;
    # softmax, LayerNorm, renorm and the Gaussian head stay f32.
    matmul_dtype: str = "f32"


@_frozen
class NetworkConfig:
    """Policy-network sizes (reference arguments.py:153-194)."""

    human_node_rnn_size: int = 128        # arguments.py:155
    human_human_edge_rnn_size: int = 256  # arguments.py:157
    human_node_input_size: int = 3        # arguments.py:167
    human_human_edge_input_size: int = 2  # arguments.py:169
    human_node_output_size: int = 256     # arguments.py:171
    human_node_embedding_size: int = 64   # arguments.py:175
    human_human_edge_embedding_size: int = 64  # arguments.py:177
    attention_size: int = 64              # arguments.py:181
    use_self_attn: bool = True            # arguments.py:189
    use_hr_attn: bool = True              # arguments.py:193
    sort_humans: bool = True              # arguments.py:206
    # self-attention stack (selfAttn_srnn_temp_node.py:29-30)
    num_attn_heads: int = 8
    attn_size: int = 512
    # route the human-human attention through the fused graph-attention
    # kernel (ops/masked_attention.py fused_graph_attention: QKV projection +
    # masked MHA + out-projection in one pass) instead of the einsum path.
    # The name is kept from the JAX package so config snapshots load as-is.
    use_pallas_attention: bool = True
    pallas_dtype: str = "bfloat16"    # "float32" for strict parity
    # "all" | "rollout": where the kernel runs once the training slice
    # lands (the port's inference path always uses it when enabled)
    pallas_scope: str = "all"
    # ring attention over the agent axis: the port has no process group,
    # so the dense branch runs, as the JAX package's does without a mesh
    use_ring_attention: bool = False
    ring_axis: str = "tp"


@_frozen
class PPOConfig:
    """PPO hyperparameters (reference arguments.py:47-151)."""

    seed: int = 425                   # arguments.py:47
    num_processes: int = 16           # arguments.py:52 (env batch; here: vectorized envs)
    num_mini_batch: int = 2           # arguments.py:58
    num_steps: int = 30               # arguments.py:63
    ppo_epoch: int = 5                # arguments.py:74
    clip_param: float = 0.2           # arguments.py:79
    value_loss_coef: float = 0.5      # arguments.py:84
    entropy_coef: float = 0.0         # arguments.py:89
    lr: float = 4e-5                  # arguments.py:92
    eps: float = 1e-5                 # arguments.py:96
    gamma: float = 0.99               # arguments.py:105
    max_grad_norm: float = 0.5        # arguments.py:110
    num_env_steps: int = 20_000_000   # arguments.py:116
    use_linear_lr_decay: bool = False  # arguments.py:122
    save_interval: int = 200          # arguments.py:129
    use_gae: bool = True              # arguments.py:135
    gae_lambda: float = 0.95          # arguments.py:140
    log_interval: int = 20            # arguments.py:145
    use_proper_time_limits: bool = False  # arguments.py:149
    use_clipped_value_loss: bool = True


@_frozen
class Config:
    """Top-level config bundle.

    ``env_name`` selects the env family exactly like the reference gym ids
    (crowd_sim/__init__.py:1-31):
      'CrowdSimVarNum'      -> no prediction         (sim.predict_method='none')
      'CrowdSimPred'        -> const_vel/truth pred  (sim.predict_method in both)
      'CrowdSimPredRealGST' -> neural GST pred       (sim.predict_method='inferred')
    """

    env_name: str = "CrowdSimPredRealGST"
    env: EnvConfig = EnvConfig()
    reward: RewardConfig = RewardConfig()
    sim: SimConfig = SimConfig()
    humans: HumansConfig = HumansConfig()
    robot: RobotConfig = RobotConfig()
    action_space: ActionSpaceConfig = ActionSpaceConfig()
    orca: OrcaConfig = OrcaConfig()
    sf: SocialForceConfig = SocialForceConfig()
    lidar: LidarConfig = LidarConfig()
    data: DataConfig = DataConfig()
    pred: PredConfig = PredConfig()
    network: NetworkConfig = NetworkConfig()
    ppo: PPOConfig = PPOConfig()

    def __post_init__(self):
        # cross-validation mirroring reference config.py:162-165
        if self.env_name == "CrowdSimPredRealGST" and self.sim.predict_method != "inferred":
            raise ValueError("CrowdSimPredRealGST requires sim.predict_method='inferred'")
        if self.sim.predict_method == "inferred" and self.env_name != "CrowdSimPredRealGST":
            raise ValueError("predict_method='inferred' requires env_name='CrowdSimPredRealGST'")
        if self.env_name == "CrowdSimVarNum" and self.sim.predict_method != "none":
            raise ValueError("CrowdSimVarNum requires sim.predict_method='none'")

    # ---- derived quantities -------------------------------------------------
    @property
    def pred_interval(self) -> int:
        # crowd_sim.py:180
        return int(self.data.pred_timestep // self.env.time_step)

    @property
    def buffer_len(self) -> int:
        # truth-rollout horizon, crowd_sim.py:181
        return self.sim.predict_steps * self.pred_interval

    @property
    def obs_buffer_len(self) -> int:
        # GST observation history depth, vec_pretext_normalize.py:57
        return (self.pred.obs_seq_len - 1) * self.pred_interval + 1

    @property
    def spatial_edge_dim(self) -> int:
        """Per-human feature width of obs['spatial_edges'].

        2 for the no-prediction env (crowd_sim_var_num.py:48), 2*(K+1) when
        predictions are appended (crowd_sim_pred.py:50-52).
        """
        if self.sim.predict_method == "none":
            return 2
        return 2 * (self.sim.predict_steps + 1)

    @property
    def max_episode_steps(self) -> int:
        # calc_reward: done when global_time >= time_limit - 1 (crowd_sim_var_num.py:513);
        # global_time at reward time is step_counter * time_step.
        return int((self.env.time_limit - 1.0) / self.env.time_step) + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def varnum_config(human_num: int = 20, human_num_range: int = 0, **kw) -> Config:
    """Config #1 of BASELINE.json: no-prediction env."""
    return Config(
        env_name="CrowdSimVarNum",
        sim=SimConfig(human_num=human_num, human_num_range=human_num_range,
                      predict_method="none"),
        **kw,
    )


def pred_config(predict_method: str = "const_vel", human_num: int = 20,
                human_num_range: int = 0, **kw) -> Config:
    """Config #2: analytic predictor env (const_vel or truth)."""
    return Config(
        env_name="CrowdSimPred",
        sim=SimConfig(human_num=human_num, human_num_range=human_num_range,
                      predict_method=predict_method),
        **kw,
    )


def gst_config(human_num: int = 20, human_num_range: int = 0, **kw) -> Config:
    """Config #3/#4: neural GST predictor env."""
    return Config(
        env_name="CrowdSimPredRealGST",
        sim=SimConfig(human_num=human_num, human_num_range=human_num_range,
                      predict_method="inferred"),
        **kw,
    )


def build_config(args) -> Config:
    """A run's config from the CLI flags of ``train`` and ``test`` (JAX
    ``train.py:43-85``, which the JAX ``test.py:116`` calls too): the env
    from ``env_name`` with ``human_num``, ``human_num_range`` and, for
    CrowdSimPred, ``predict_method``; the PPO fields from the flags, with
    the config's own values for flags a CLI does not have (test has no
    minibatch, epoch, entropy or lr-decay flags); and the optional overrides
    ``randomize_attributes``, ``kinematics``, ``robot_v_pref``,
    ``spin_warmup_steps`` and ``gst_matmul_dtype``."""
    if args.env_name == "CrowdSimVarNum":
        cfg = varnum_config(human_num=args.human_num,
                            human_num_range=args.human_num_range)
    elif args.env_name == "CrowdSimPred":
        cfg = pred_config(predict_method=args.predict_method,
                          human_num=args.human_num,
                          human_num_range=args.human_num_range)
    elif args.env_name == "CrowdSimPredRealGST":
        cfg = gst_config(human_num=args.human_num,
                         human_num_range=args.human_num_range)
    else:
        raise ValueError(args.env_name)
    cfg = cfg.replace(ppo=dataclasses.replace(
        cfg.ppo, num_processes=args.num_processes, num_steps=args.num_steps,
        num_env_steps=args.num_env_steps, lr=args.lr, seed=args.seed,
        num_mini_batch=getattr(args, "num_mini_batch", cfg.ppo.num_mini_batch),
        ppo_epoch=getattr(args, "ppo_epoch", cfg.ppo.ppo_epoch),
        entropy_coef=getattr(args, "entropy_coef", cfg.ppo.entropy_coef),
        use_linear_lr_decay=getattr(args, "use_linear_lr_decay",
                                    cfg.ppo.use_linear_lr_decay)))
    if not getattr(args, "randomize_attributes", True):
        cfg = cfg.replace(env=dataclasses.replace(
            cfg.env, randomize_attributes=False))
    if getattr(args, "kinematics", None):
        cfg = cfg.replace(action_space=dataclasses.replace(
            cfg.action_space, kinematics=args.kinematics))
    if getattr(args, "robot_v_pref", None):
        cfg = cfg.replace(robot=dataclasses.replace(
            cfg.robot, v_pref=args.robot_v_pref))
    if getattr(args, "spin_warmup_steps", 0):
        cfg = cfg.replace(reward=dataclasses.replace(
            cfg.reward, spin_penalty_warmup_steps=args.spin_warmup_steps))
    if getattr(args, "gst_matmul_dtype", None):
        cfg = cfg.replace(pred=dataclasses.replace(
            cfg.pred, matmul_dtype=args.gst_matmul_dtype))
    return cfg


def config_from_snapshot(path: str) -> Config:
    """Rebuild a Config from a run's ``config.json`` (JAX package
    ``test.py:41-60``): unknown keys are ignored, nested groups are rebuilt
    into their dataclasses."""
    with open(path) as f:
        d = json.load(f)

    def build(cls, sub):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in sub.items():
            if k not in fields:
                continue
            default = fields[k].default
            if dataclasses.is_dataclass(default) and isinstance(v, dict):
                kw[k] = build(default.__class__, v)
            else:
                kw[k] = v
        return cls(**kw)

    return build(Config, d)
