"""Sim2real deployment shell (JAX package ``sim2real.py``; reference
crowd_sim/envs/ros_turtlebot2i_env.py).

The reference wraps a ROS TurtleBot2i: DR-SPAAM human detections + joint
states in, cmd_vel out, with the same observation contract as the simulator.
ROS is hardware-bound; this module keeps the full contract testable by
separating the env logic from the transport:

  * ``DetectionSource``: abstract sensor interface (``read() ->
    (robot_pose, robot_vel, human_positions, human_mask)``).
  * ``DummyDetectionSource``: the reference's ``use_dummy_detect`` mode
    (config.py:155, ros_turtlebot2i_env.py:86-98): fabricated detections, no
    hardware needed.
  * ``RosDetectionSource``: rospy-backed source, importing ROS only when
    built (subscribes /joint_states + /dr_spaam_detections, publishes
    /cmd_vel_mux/input/navi like ros_turtlebot2i_env.py:80-98).
  * ``Sim2RealEnv``: builds the exact dict observation the policy saw in
    training (robot_node / temporal_edges / spatial_edges with tiled
    predictions / visible_masks / detected_human_num,
    ros_turtlebot2i_env.py:104-140 + 355-420) and applies the TurtleBot wheel
    smoothing model (smooth(), ros_turtlebot2i_env.py:343-357). The env is
    NumPy; ``policy_obs`` turns its observation into the policy's batch of
    one on the policy's device.
  * ``record_sim_episode`` / ``replay_actions``: record one simulator
    episode's actions and positions, and replay the actions through the
    simulator on the device (system identification without hardware).
"""

from __future__ import annotations

import abc
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .algo.evaluation import case_generator
from .config import Config
from .env import crowd_sim
from .env.pretext import pretext_process
from .models import policy as policy_mod
from .models.policy_net import init_hidden, obs_to_dict
from .utils.device import resolve_device
from .utils.recorder import Recorder


class DetectionSource(abc.ABC):
    @abc.abstractmethod
    def read(self):
        """-> (robot_pose (3,) [px, py, theta], robot_vel (2,),
              human_pos (A, 2), human_mask (A,))"""

    @abc.abstractmethod
    def send_cmd(self, v: float, w: float):
        """Publish a velocity command."""


class DummyDetectionSource(DetectionSource):
    """Fabricated robot/human states (use_dummy_detect)."""

    def __init__(self, cfg: Config, seed: int = 0):
        self.cfg = cfg
        A = cfg.sim.max_human_num
        rng = np.random.RandomState(seed)
        self.robot_pose = np.zeros(3)
        self.robot_vel = np.zeros(2)
        self.human_pos = rng.uniform(-4, 4, (A, 2))
        self.human_vel = rng.uniform(-0.5, 0.5, (A, 2))
        self.human_mask = np.zeros(A, bool)
        self.human_mask[: cfg.sim.human_num] = True

    def read(self):
        # humans drift at constant velocity; robot integrates sent commands
        self.human_pos += self.human_vel * self.cfg.env.time_step
        return (self.robot_pose.copy(), self.robot_vel.copy(),
                self.human_pos.copy(), self.human_mask.copy())

    def send_cmd(self, v: float, w: float):
        dt = self.cfg.env.time_step
        self.robot_pose[2] += w * dt
        self.robot_vel = np.array([v * np.cos(self.robot_pose[2]),
                                   v * np.sin(self.robot_pose[2])])
        self.robot_pose[:2] += self.robot_vel * dt


def pose_from_transform(translation) -> Tuple[float, float]:
    """T265 odom -> world position (ros_turtlebot2i_env.py:181-182): the
    camera frame is rotated 90 degrees, so px = -t.y, py = t.x."""
    return -float(translation.y), float(translation.x)


def theta_from_quaternion(qx: float, qy: float, qz: float, qw: float) -> float:
    """Robot heading from the T265 orientation quaternion
    (ros_turtlebot2i_env.py:185-218): yaw + pi/2 (camera-to-base rotation),
    wrapped to [0, 2*pi)."""
    yaw = np.arctan2(2.0 * (qw * qz + qx * qy),
                     1.0 - 2.0 * (qy * qy + qz * qz))
    theta = yaw + np.pi / 2.0
    if theta < 0.0:
        theta += 2.0 * np.pi
    return float(theta)


def detections_to_robot_frame(raw_xy: np.ndarray, theta: float) -> np.ndarray:
    """Rotate DR-SPAAM lidar-frame detections into the world-aligned robot
    frame (ros_turtlebot2i_env.py:220-235): the lidar is mounted 180 degrees
    from the T265, so the rotation angle is theta + pi. Positions stay
    robot-centered (the reference never adds the robot position)."""
    ang = theta + np.pi
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]])
    return (rot @ np.asarray(raw_xy, float).T).T


class RosDetectionSource(DetectionSource):
    """rospy-backed source (ros_turtlebot2i_env.py:66-101 configure +
    157-243 readMsg). Imports ROS lazily so the module stays importable off
    the robot; tests inject a fake rospy/tf2_ros/message_filters stack.

    ``use_dummy_detect`` mirrors config.sim2real.use_dummy_detect
    (config.py:155): subscribe only /joint_states and fabricate one human at
    world (0, 1) (ros_turtlebot2i_env.py:86-98, 237-238).
    """

    def __init__(self, cfg: Config, use_dummy_detect: bool = False,
                 node_name: str = "crowdnav_tpu_sim2real"):
        import rospy
        import tf2_ros
        import message_filters
        from geometry_msgs.msg import Twist, PoseArray
        from sensor_msgs.msg import JointState

        self.cfg = cfg
        self.use_dummy_detect = use_dummy_detect
        self._rospy = rospy
        self._Twist = Twist
        from threading import Lock
        self._mutex = Lock()

        self._joint_msg = None
        self._human_msg = None
        self.joint_vel = None           # wheel velocities for the recorder
        self.current_time = 0.0
        self.last_v = 0.0               # last commanded linear speed

        rospy.init_node(node_name, anonymous=True)
        self.pub = rospy.Publisher("/cmd_vel_mux/input/navi", Twist,
                                   queue_size=1)
        self._tf_buffer = tf2_ros.Buffer()
        self._tf_listener = tf2_ros.TransformListener(self._tf_buffer)

        joint_sub = message_filters.Subscriber("/joint_states", JointState)
        if use_dummy_detect:
            subs = [joint_sub]
            cb = self._state_cb_dummy
        else:
            human_sub = message_filters.Subscriber("/dr_spaam_detections",
                                                   PoseArray)
            subs = [joint_sub, human_sub]
            cb = self._state_cb
        # sync base joint states and detections within 1 s
        # (ros_turtlebot2i_env.py:91-92)
        self._ats = message_filters.ApproximateTimeSynchronizer(
            subs, queue_size=1, slop=1)
        self._ats.registerCallback(cb)
        rospy.on_shutdown(self.stop)

    # callbacks only stash messages; all math happens in read()
    # (ros_turtlebot2i_env.py:147-155)
    def _state_cb(self, joint_msg, human_array_msg):
        with self._mutex:
            self._joint_msg = joint_msg
            self._human_msg = human_array_msg.poses

    def _state_cb_dummy(self, joint_msg):
        with self._mutex:
            self._joint_msg = joint_msg

    def read(self):
        """readMsg (ros_turtlebot2i_env.py:157-243): joint-state time, T265
        pose via tf, DR-SPAAM detections rotated into the robot frame.

        Returns (pose (3,), vel (2,), human_pos (A, 2) ABSOLUTE, mask (A,)).
        Note the reference keeps ``human_visibility`` all-False even for
        detected humans (readMsg:198-211) and drives the policy through
        ``detected_human_num`` alone; here the mask marks the detected slots
        (the first ``detected_human_num`` entries), which reduces to the same
        observation through Sim2RealEnv.observe().
        """
        A = self.cfg.sim.max_human_num
        rospy = self._rospy
        with self._mutex:
            joint_msg = self._joint_msg
            human_msg = self._human_msg
        if joint_msg is None:
            raise RuntimeError("no /joint_states message received yet")
        self.current_time = (joint_msg.header.stamp.secs
                             + joint_msg.header.stamp.nsecs / 1e9)
        try:
            self.joint_vel = joint_msg.velocity
        except AttributeError:
            pass

        tfm = self._tf_buffer.lookup_transform(
            "t265_odom_frame", "t265_pose_frame", rospy.Time.now(),
            rospy.Duration(1.0))
        px, py = pose_from_transform(tfm.transform.translation)
        q = tfm.transform.rotation
        theta = theta_from_quaternion(q.x, q.y, q.z, q.w)

        human_rel = np.full((A, 2), 15.0)
        mask = np.zeros(A, bool)
        if self.use_dummy_detect:
            # one fabricated human at world (0, 1)
            human_rel[0] = np.array([0.0, 1.0]) - np.array([px, py])
            mask[0] = True
        elif human_msg is not None:
            n = min(len(human_msg), A)
            raw = np.array([[p.position.x, p.position.y]
                            for p in human_msg[:n]], float).reshape(n, 2)
            human_rel[:n] = detections_to_robot_frame(raw, theta)
            mask[:n] = True

        vel = self.last_v * np.array([np.cos(theta), np.sin(theta)])
        pose = np.array([px, py, theta])
        # Sim2RealEnv.observe subtracts the robot position again, so return
        # absolute positions (the reference's spatial_edges are robot-centered)
        return pose, vel, human_rel + pose[:2], mask

    def send_cmd(self, v, w):
        msg = self._Twist()
        msg.linear.x = v
        msg.angular.z = w
        self.last_v = float(v)
        self.pub.publish(msg)

    def sleep(self, seconds: float):
        """Frame-skip between command and next sensor read
        (ros_turtlebot2i_env.py:369)."""
        self._rospy.sleep(seconds)

    def stop(self):
        """smoothStop (ros_turtlebot2i_env.py:526-528)."""
        self.pub.publish(self._Twist())


def record_sim_episode(cfg: Config, case_idx: int = 0,
                       robot_policy: str = "orca", policy=None,
                       gst_model=None, out_dir: Optional[str] = None,
                       phase: str = "test", max_steps: Optional[int] = None,
                       device="cuda"):
    """Run ONE simulator episode on ``device`` and record the robot's
    actions/positions/orientations (reference record path:
    crowd_sim_pred.py:144-152 appends to episodeRecoder each step and
    saveEpisode on done). The episode is the seeded case
    ``case_generator(cfg.ppo.seed, case_idx, phase)``.

    With ``robot_policy="network"`` the ``policy`` (a PolicyHead on
    ``device``) acts deterministically and its raw action is recorded, so
    replay goes through the same clipping; in the ``inferred`` env
    ``gst_model`` runs the pretext pass on the policy's observations. A
    scripted robot's executed velocity is recorded instead. Returns
    (recorder, steps); with ``out_dir`` the CSVs are written like
    recorder.py:36-50 (``<case>_actions.csv`` etc.).
    """
    device = resolve_device(device)
    state, obs = crowd_sim.reset(
        cfg, [case_generator(cfg.ppo.seed, case_idx, phase)], device)
    network = robot_policy == "network"
    use_pretext = (network and cfg.sim.predict_method == "inferred"
                   and gst_model is not None)
    if use_pretext:
        state, obs, _, _ = pretext_process(cfg, gst_model, state, obs,
                                           torch.zeros(1, device=device))
    rec = Recorder()
    hxs = init_hidden(cfg, 1, device)
    masks = torch.ones(1, device=device)
    steps = 0
    with torch.no_grad():
        for _ in range(max_steps or cfg.max_episode_steps):
            if network:
                _, action, _, hxs = policy_mod.act(
                    policy, obs_to_dict(obs), hxs, masks, deterministic=True)
            else:
                action = torch.zeros(1, 2, device=device)
            state, obs, rew, done, _ = crowd_sim.step(cfg, state, action,
                                                      phase, robot_policy)
            if use_pretext:
                state, obs, rew, _ = pretext_process(cfg, gst_model, state,
                                                     obs, rew)
            v = state.robot.vel[0].cpu().numpy()
            pos = state.robot.pos[0].cpu().numpy()
            heading = float(np.arctan2(v[1], v[0]))
            rec.add_step(action[0].cpu().numpy() if network else v, pos,
                         heading)
            steps += 1
            if bool(done[0]):
                break
    rec.robot_goal.append(list(state.robot.goal[0].cpu().numpy()))
    if out_dir:
        rec.save_episode(out_dir, case_idx)
    return rec, steps


def replay_actions(cfg: Config, actions: np.ndarray, case_idx: int = 0,
                   phase: str = "test", device="cuda") -> np.ndarray:
    """Replay a recorded (T, 2) action array through the simulator on
    ``device`` (reference crowd_sim.py:169-173 + recorder.py:52-56
    loadActions: the env consumes pre-recorded actions instead of the
    policy, for dynamics / system identification). Returns the (T, 2) robot
    positions, which must be bit-exact vs the recording: the step is a
    deterministic function of (state, action), and the case's generator
    draws the same numbers again."""
    device = resolve_device(device)
    state, _ = crowd_sim.reset(
        cfg, [case_generator(cfg.ppo.seed, case_idx, phase)], device)
    pos = []
    with torch.no_grad():
        for a in np.asarray(actions, np.float32):
            action = torch.from_numpy(a).to(device).reshape(1, 2)
            state, _, _, done, _ = crowd_sim.step(cfg, state, action, phase,
                                                  "network")
            pos.append(state.robot.pos[0].cpu().numpy())
            if bool(done[0]):
                break
    return np.asarray(pos)


def policy_obs(ob: dict, device) -> Dict[str, torch.Tensor]:
    """A ``Sim2RealEnv`` observation as the policy's input: a batch of one,
    as tensors on ``device``."""
    return {
        "robot_node": torch.from_numpy(ob["robot_node"]).to(device),
        "temporal_edges": torch.from_numpy(ob["temporal_edges"]).to(device),
        "spatial_edges": torch.from_numpy(ob["spatial_edges"])[None].to(device),
        "visible_masks": torch.from_numpy(ob["visible_masks"])[None].to(device),
        "detected_human_num": torch.from_numpy(
            ob["detected_human_num"]).long().to(device),
    }


class Sim2RealEnv:
    """Observation/action adapter between real sensors and the trained policy."""

    def __init__(self, cfg: Config, source: DetectionSource, goal=(0.0, 2.0)):
        self.cfg = cfg
        self.source = source
        self.goal = np.asarray(goal, float)
        A = cfg.sim.max_human_num
        self.prev_human_pos = np.full((A, 2), 15.0)
        self.last_left = 0.0
        self.last_right = 0.0
        # accumulated desired velocity (ros_turtlebot2i_env.py:60,354-355)
        self.v_desired = 0.0
        self.global_time = 0.0
        self.step_counter = 0

    def smooth(self, v: float, w: float) -> Tuple[float, float]:
        """TurtleBot2i wheel low-pass (ros_turtlebot2i_env.py:343-357)."""
        beta = 0.1
        left = (2.0 * v - 0.23 * w) / (2.0 * 0.035)
        right = (2.0 * v + 0.23 * w) / (2.0 * 0.035)
        left = float(np.clip(left, -17.5, 17.5))
        right = float(np.clip(right, -17.5, 17.5))
        left = (1.0 - beta) * self.last_left + beta * left
        right = (1.0 - beta) * self.last_right + beta * right
        self.last_left, self.last_right = left, right
        return 0.035 / 2.0 * (left + right), 0.035 / 0.23 * (right - left)

    def observe(self) -> dict:
        cfg = self.cfg
        A = cfg.sim.max_human_num
        K = cfg.sim.predict_steps
        pose, vel, human_pos, mask = self.source.read()
        rel = np.where(mask[:, None], human_pos - pose[:2], 15.0)
        if cfg.sim.predict_method == "none":
            spatial = rel.astype(np.float32)
        else:
            spatial = np.tile(rel, (1, K + 1)).astype(np.float32)
        self.prev_human_pos = np.where(mask[:, None], human_pos,
                                       self.prev_human_pos)
        return {
            "robot_node": np.array([[*pose[:2], cfg.robot.radius, *self.goal,
                                     cfg.robot.v_pref, pose[2]]], np.float32),
            "temporal_edges": vel[None].astype(np.float32),
            "spatial_edges": spatial,
            "visible_masks": mask,
            "detected_human_num": np.array([max(int(mask.sum()), 1)],
                                           np.float32),
        }

    def act(self, raw_action) -> Tuple[float, float]:
        """Clip per kinematics and publish; returns (v, w) sent."""
        a = np.asarray(raw_action, float).ravel()
        if self.cfg.action_space.kinematics == "holonomic":
            n = np.linalg.norm(a)
            if n > self.cfg.robot.v_pref:
                a = a / n * self.cfg.robot.v_pref
            v = float(np.linalg.norm(a))
            w = float(np.arctan2(a[1], a[0]))
        else:
            # unicycle actions are (delta v, delta theta); the desired linear
            # speed ACCUMULATES and is clipped to +-v_pref, the turn rate is
            # delta theta over the fixed step (srnn.py:17-44 clip +
            # ros_turtlebot2i_env.py:352-355)
            dv = float(np.clip(a[0], -0.1, 0.087))
            dth = float(np.clip(a[1], -0.06, 0.06))
            self.v_desired = float(np.clip(self.v_desired + dv,
                                           -self.cfg.robot.v_pref,
                                           self.cfg.robot.v_pref))
            v, w = self.v_desired, dth / self.cfg.env.time_step
        v, w = self.smooth(v, w)
        self.source.send_cmd(v, w)
        return v, w

    def reset(self, goal=None) -> dict:
        """Reset bookkeeping and read the first observation
        (ros_turtlebot2i_env.py:248-288, minus the interactive goal prompt —
        pass ``goal`` instead)."""
        if goal is not None:
            self.goal = np.asarray(goal, float)
        if hasattr(self.source, "stop"):
            self.source.stop()
        self.global_time = 0.0
        self.step_counter = 0
        self.v_desired = 0.0
        self.last_left = 0.0
        self.last_right = 0.0
        self.prev_human_pos = np.full((self.cfg.sim.max_human_num, 2), 15.0)
        return self.observe()

    def step(self, raw_action, frame_skip: float = 0.0
             ) -> Tuple[dict, float, bool, dict]:
        """One real-robot step (ros_turtlebot2i_env.py:339-428): publish the
        smoothed command, optionally wait ``frame_skip`` seconds (the
        reference's ROSStepInterval), read sensors, advance the fixed time
        interval, and terminate on goal (< 0.6 m) or the time limit."""
        v, w = self.act(raw_action)
        if frame_skip > 0.0 and hasattr(self.source, "sleep"):
            self.source.sleep(frame_skip)
        ob = self.observe()
        if self.step_counter > 0:
            self.global_time += self.cfg.env.time_step
        self.step_counter += 1
        pos = ob["robot_node"][0, :2]
        reaching = float(np.linalg.norm(self.goal - pos)) < 0.6
        timeout = self.global_time >= self.cfg.env.time_limit
        done = bool(reaching or timeout)
        info = {"event": "goal" if reaching else
                ("timeout" if timeout else None),
                "v": v, "w": w}
        return ob, 0.0, done, info
