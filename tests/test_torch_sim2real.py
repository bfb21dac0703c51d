"""The sim2real shell on the port: the JAX package's tests/test_sim2real.py
and tests/test_sim2real_ros.py cases (the fake-ROS fixture copied from the
latter, :20-137), plus exact equality with the JAX shell, which is NumPy in
both packages: the same DummyDetectionSource seed and actions give the same
observations, commands and source states, holonomic and unicycle, and the
same fake ROS messages give the same observation. ``policy_obs`` feeds an
observation to the port's policy on the CPU.

Reference oracle: crowd_sim/envs/ros_turtlebot2i_env.py
  configure:66-101   (node, publisher, synchronized subscribers)
  readMsg:157-243    (time, tf pose, quaternion->theta, detection rotation)
  step:339-428       (smooth, publish, fixed time interval, done rules)
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu import sim2real as jsim2real
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch import sim2real
from crowdnav_prediction_attngraph_tpu_torch.config import (
    gst_config, varnum_config)
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    init_hidden)


# ---------------------------------------------------------------------------
# fake ROS message/infra objects
# ---------------------------------------------------------------------------

class _Obj:
    """Attribute bag (stands in for genpy message fields)."""

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def make_joint_msg(secs=100, nsecs=500_000_000, velocity=(1.0, 2.0)):
    return _Obj(header=_Obj(stamp=_Obj(secs=secs, nsecs=nsecs)),
                velocity=list(velocity))


def make_pose_array(points):
    return _Obj(poses=[_Obj(position=_Obj(x=float(x), y=float(y), z=0.0))
                       for x, y in points])


def make_transform(tx, ty, qz, qw, qx=0.0, qy=0.0):
    return _Obj(transform=_Obj(
        translation=_Obj(x=float(tx), y=float(ty), z=0.0),
        rotation=_Obj(x=qx, y=qy, z=qz, w=qw)))


class FakeTfBuffer:
    def __init__(self):
        self.transform = make_transform(0.0, 0.0, 0.0, 1.0)

    def lookup_transform(self, target, source, t, timeout=None):
        assert target == "t265_odom_frame" and source == "t265_pose_frame"
        return self.transform


class FakePublisher:
    def __init__(self, topic, msg_type, queue_size=1):
        self.topic = topic
        self.published = []

    def publish(self, msg):
        self.published.append(msg)


class FakeSubscriber:
    def __init__(self, topic, msg_type):
        self.topic = topic


class FakeATS:
    instances = []

    def __init__(self, subs, queue_size=1, slop=1):
        self.subs = subs
        self.queue_size = queue_size
        self.slop = slop
        self.callback = None
        FakeATS.instances.append(self)

    def registerCallback(self, cb):
        self.callback = cb


class FakeTwist:
    def __init__(self):
        self.linear = _Obj(x=0.0, y=0.0, z=0.0)
        self.angular = _Obj(x=0.0, y=0.0, z=0.0)


@pytest.fixture
def fake_ros(monkeypatch):
    """Install fake rospy / tf2_ros / message_filters / geometry_msgs /
    sensor_msgs into sys.modules and return the module handles."""
    rospy = types.ModuleType("rospy")
    rospy.sleeps = []
    rospy.init_node = lambda name, anonymous=True: None
    rospy.Publisher = FakePublisher
    rospy.Time = types.SimpleNamespace(now=lambda: 0.0)
    rospy.Duration = lambda s: s
    rospy.sleep = lambda s: rospy.sleeps.append(s)
    rospy.on_shutdown = lambda cb: None

    tf2_ros = types.ModuleType("tf2_ros")
    tf2_ros.Buffer = FakeTfBuffer
    tf2_ros.TransformListener = lambda buf: None

    message_filters = types.ModuleType("message_filters")
    message_filters.Subscriber = FakeSubscriber
    message_filters.ApproximateTimeSynchronizer = FakeATS

    geometry = types.ModuleType("geometry_msgs")
    geometry_msg = types.ModuleType("geometry_msgs.msg")
    geometry_msg.Twist = FakeTwist
    geometry_msg.PoseArray = object
    geometry.msg = geometry_msg

    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")
    sensor_msg.JointState = object
    sensor.msg = sensor_msg

    for name, mod in [("rospy", rospy), ("tf2_ros", tf2_ros),
                      ("message_filters", message_filters),
                      ("geometry_msgs", geometry),
                      ("geometry_msgs.msg", geometry_msg),
                      ("sensor_msgs", sensor),
                      ("sensor_msgs.msg", sensor_msg)]:
        monkeypatch.setitem(sys.modules, name, mod)
    FakeATS.instances = []
    return rospy


def _make_source(cfg, module=sim2real, **kw):
    return module.RosDetectionSource(cfg, **kw)


def _unicycle(cfg):
    return cfg.replace(action_space=dataclasses.replace(
        cfg.action_space, kinematics="unicycle"))


# ---------------------------------------------------------------------------
# tests/test_sim2real.py: the dummy source and the observation contract
# ---------------------------------------------------------------------------

def test_observation_contract_gst():
    cfg = gst_config(human_num=6)
    env = sim2real.Sim2RealEnv(cfg, sim2real.DummyDetectionSource(cfg),
                               goal=(1.0, 2.0))
    ob = env.observe()
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    assert ob["robot_node"].shape == (1, 7)
    assert ob["temporal_edges"].shape == (1, 2)
    assert ob["spatial_edges"].shape == (A, 2 * (K + 1))
    assert ob["visible_masks"].shape == (A,)
    assert int(ob["detected_human_num"][0]) >= 1
    assert np.all(np.isfinite(ob["spatial_edges"]))


def test_observation_contract_varnum():
    cfg = varnum_config(human_num=4)
    env = sim2real.Sim2RealEnv(cfg, sim2real.DummyDetectionSource(cfg))
    assert env.observe()["spatial_edges"].shape == (4, 2)


def test_action_clipping_and_motion():
    cfg = varnum_config(human_num=4)
    src = sim2real.DummyDetectionSource(cfg)
    env = sim2real.Sim2RealEnv(cfg, src)
    p0 = src.robot_pose.copy()
    for _ in range(20):
        env.act(np.array([2.0, 0.0]))  # over-speed: clipped to v_pref
        env.observe()
    assert np.linalg.norm(src.robot_pose[:2] - p0[:2]) > 0.1
    # wheel smoothing keeps commanded v bounded
    v, w = env.smooth(10.0, 0.0)
    assert v <= 0.035 * 17.5 + 1e-6


# ---------------------------------------------------------------------------
# tests/test_sim2real_ros.py: odometry/detection math and the ROS source
# ---------------------------------------------------------------------------

def test_pose_from_transform():
    # readMsg:181-182: px = -translation.y, py = translation.x
    px, py = sim2real.pose_from_transform(_Obj(x=1.5, y=-2.0, z=0.0))
    assert (px, py) == (2.0, 1.5)


def test_theta_from_quaternion_wraps():
    assert np.isclose(sim2real.theta_from_quaternion(0, 0, 0, 1), np.pi / 2)
    qz, qw = np.sin(-3 * np.pi / 8), np.cos(-3 * np.pi / 8)
    th = sim2real.theta_from_quaternion(0, 0, qz, qw)
    assert np.isclose(th, -3 * np.pi / 4 + np.pi / 2 + 2 * np.pi)
    assert 0.0 <= th < 2 * np.pi


def test_detection_rotation_matches_hmatrix():
    # oracle: the reference's 4x4 hMatrix product (readMsg:220-235)
    raw = np.random.RandomState(0).randn(5, 2)
    theta = 0.7
    a = theta + np.pi
    h = np.array([[np.cos(a), -np.sin(a), 0, 0],
                  [np.sin(a), np.cos(a), 0, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    want = np.stack([(h @ np.array([x, y, 0.0, 1.0]))[:2] for x, y in raw])
    np.testing.assert_allclose(sim2real.detections_to_robot_frame(raw, theta),
                               want, atol=1e-12)


def test_subscriber_wiring(fake_ros):
    cfg = gst_config(human_num=4)
    src = _make_source(cfg)
    ats = FakeATS.instances[-1]
    assert [s.topic for s in ats.subs] == ["/joint_states",
                                           "/dr_spaam_detections"]
    assert ats.queue_size == 1 and ats.slop == 1
    assert src.pub.topic == "/cmd_vel_mux/input/navi"
    src2 = _make_source(cfg, use_dummy_detect=True)
    assert [s.topic for s in FakeATS.instances[-1].subs] == ["/joint_states"]
    assert src2.use_dummy_detect


def test_read_requires_message(fake_ros):
    src = _make_source(gst_config(human_num=4))
    with pytest.raises(RuntimeError):
        src.read()


def test_message_to_observation_parity(fake_ros):
    cfg = gst_config(human_num=4)
    src = _make_source(cfg)
    ats = FakeATS.instances[-1]
    qz, qw = np.sin(np.pi / 6), np.cos(np.pi / 6)
    src._tf_buffer.transform = make_transform(tx=1.0, ty=-2.0, qz=qz, qw=qw)
    detections = [(1.0, 0.5), (-0.5, 2.0)]
    ats.callback(make_joint_msg(secs=10, nsecs=250_000_000,
                                velocity=(0.3, 0.4)),
                 make_pose_array(detections))
    src.last_v = 0.5
    pose, vel, human_pos, mask = src.read()
    theta = np.pi / 3 + np.pi / 2
    np.testing.assert_allclose(pose, [2.0, 1.0, theta], atol=1e-12)
    np.testing.assert_allclose(
        vel, 0.5 * np.array([np.cos(theta), np.sin(theta)]), atol=1e-12)
    assert src.current_time == 10.25
    assert list(src.joint_vel) == [0.3, 0.4]
    a = theta + np.pi
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    want_rel = (rot @ np.asarray(detections).T).T
    np.testing.assert_allclose(human_pos[:2], want_rel + pose[:2], atol=1e-12)
    assert mask.tolist() == [True, True, False, False]
    np.testing.assert_allclose(human_pos[2:],
                               np.tile(15.0 + pose[:2], (2, 1)), atol=1e-12)


def test_dummy_detect_mode(fake_ros):
    src = _make_source(gst_config(human_num=4), use_dummy_detect=True)
    FakeATS.instances[-1].callback(make_joint_msg())
    src._tf_buffer.transform = make_transform(0.5, -0.5, 0.0, 1.0)
    _, _, human_pos, mask = src.read()
    np.testing.assert_allclose(human_pos[0], [0.0, 1.0], atol=1e-12)
    assert mask.tolist() == [True, False, False, False]


def test_send_cmd_publishes_twist(fake_ros):
    src = _make_source(gst_config(human_num=4))
    src.send_cmd(0.4, -0.2)
    msg = src.pub.published[-1]
    assert msg.linear.x == 0.4 and msg.angular.z == -0.2
    assert src.last_v == 0.4
    src.stop()
    assert src.pub.published[-1].linear.x == 0.0


def test_env_step_loop(fake_ros):
    cfg = varnum_config(human_num=4)
    src = _make_source(cfg)
    ats = FakeATS.instances[-1]
    src._tf_buffer.transform = make_transform(0.0, 0.0, 0.0, 1.0)
    ats.callback(make_joint_msg(), make_pose_array([(1.0, 1.0)]))
    env = sim2real.Sim2RealEnv(cfg, src, goal=(0.0, 5.0))
    ob = env.reset()
    assert ob["robot_node"].shape == (1, 7)
    assert src.pub.published  # reset stops the robot
    ob, rew, done, info = env.step(np.array([0.5, 0.0]), frame_skip=0.1)
    assert rew == 0.0 and not done
    assert fake_ros.sleeps == [0.1]          # the ROSStepInterval frame skip
    assert ob["spatial_edges"].shape[0] == cfg.sim.max_human_num
    src._tf_buffer.transform = make_transform(tx=4.8, ty=0.0, qz=0.0, qw=1.0)
    ob, _, done, info = env.step(np.array([0.5, 0.0]))
    assert done and info["event"] == "goal"


def test_unicycle_velocity_accumulates(fake_ros):
    cfg = _unicycle(varnum_config(human_num=4))
    src = _make_source(cfg)
    env = sim2real.Sim2RealEnv(cfg, src)
    for _ in range(40):
        env.act(np.array([0.087, 0.0]))
    assert np.isclose(env.v_desired, cfg.robot.v_pref)
    v_cap = 0.035 / 2.0 * 2 * 17.5
    assert src.pub.published[-1].linear.x == pytest.approx(v_cap, rel=0.05)


# ---------------------------------------------------------------------------
# exact equality with the JAX package's shell
# ---------------------------------------------------------------------------

def _both(factory, unicycle, **kw):
    t_cfg = getattr(tconfig, factory)(**kw)
    j_cfg = getattr(jconfig, factory)(**kw)
    if unicycle:
        t_cfg = _unicycle(t_cfg)
        j_cfg = j_cfg.replace(action_space=dataclasses.replace(
            j_cfg.action_space, kinematics="unicycle"))
    return t_cfg, j_cfg


def _assert_obs_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("factory,unicycle", [("gst_config", False),
                                              ("varnum_config", True)])
def test_dummy_env_equals_jax(factory, unicycle):
    t_cfg, j_cfg = _both(factory, unicycle, human_num=5)
    t_src = sim2real.DummyDetectionSource(t_cfg, seed=3)
    j_src = jsim2real.DummyDetectionSource(j_cfg, seed=3)
    t_env = sim2real.Sim2RealEnv(t_cfg, t_src, goal=(1.0, 3.0))
    j_env = jsim2real.Sim2RealEnv(j_cfg, j_src, goal=(1.0, 3.0))
    _assert_obs_equal(t_env.reset(), j_env.reset())
    rng = np.random.RandomState(1)
    for _ in range(12):
        a = rng.uniform(-1.2, 1.2, 2)
        t_ob, t_rew, t_done, t_info = t_env.step(a)
        j_ob, j_rew, j_done, j_info = j_env.step(a)
        _assert_obs_equal(t_ob, j_ob)
        assert (t_rew, t_done, t_info) == (j_rew, j_done, j_info)
        assert t_env.v_desired == j_env.v_desired
        np.testing.assert_array_equal(t_src.robot_pose, j_src.robot_pose)


def test_fake_messages_give_jax_observation(fake_ros):
    qz, qw = np.sin(0.4), np.cos(0.4)
    envs, srcs = [], []
    for mod, cfg in zip((sim2real, jsim2real),
                        _both("gst_config", False, human_num=4)):
        src = _make_source(cfg, mod)
        src._tf_buffer.transform = make_transform(0.7, -1.1, qz, qw)
        FakeATS.instances[-1].callback(
            make_joint_msg(), make_pose_array([(1.0, 0.5), (-2.0, 1.5)]))
        srcs.append(src)
        envs.append(mod.Sim2RealEnv(cfg, src, goal=(0.0, 4.0)))
    _assert_obs_equal(envs[0].reset(), envs[1].reset())
    t_ob, *t_rest = envs[0].step(np.array([0.3, 0.2]))
    j_ob, *j_rest = envs[1].step(np.array([0.3, 0.2]))
    _assert_obs_equal(t_ob, j_ob)
    assert t_rest == j_rest
    assert [m.linear.x for m in srcs[0].pub.published] == \
        [m.linear.x for m in srcs[1].pub.published]


def test_policy_acts_on_observation():
    cfg = gst_config(human_num=5)
    env = sim2real.Sim2RealEnv(cfg, sim2real.DummyDetectionSource(cfg))
    policy = pmod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hxs = init_hidden(cfg, 1, "cpu")
    ob = env.reset()
    for _ in range(3):
        obs = sim2real.policy_obs(ob, "cpu")
        assert obs["spatial_edges"].shape == (1, 5, 12)
        _, action, _, hxs = pmod.act(policy, obs, hxs, torch.ones(1))
        assert action.shape == (1, 2) and torch.isfinite(action).all()
        ob, _, _, _ = env.step(action[0].numpy())
