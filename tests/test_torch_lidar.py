"""The lidar ray cast: the JAX package's six cases (tests/test_lidar.py) on
the port, with that file's bounds, and the port's ``scan`` against the JAX
``scan`` on seeded inputs (batch (3, 4), A = 7, random masks, and A = 0).

A flat atol of 1e-6 holds only where a ray misses every human (the range is
then exactly ``lidar.range``). XLA's and torch's float32 cos / sin differ by
one ulp on ~5% of the angles, and a hit's range ``t - sqrt(r^2 - (|rel|^2 -
t^2))`` cancels ``|rel|^2 - t^2``, so that ulp reaches the range
amplified by |rel|^2 / sqrt(r^2 - closest^2) (up to 6e-5 on grazing rays of
these scenes). Each hit ray is therefore held, in both packages, against
the float64 NumPy scan and against each other, to 1e-6 plus four float32
ulps of |rel|^2 over the float64 sqrt argument (the first-order rounding
bound of the cancelling terms).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.config import (
    Config as JConfig, LidarConfig as JLidarConfig)
from crowdnav_prediction_attngraph_tpu.env import lidar as jlidar
from crowdnav_prediction_attngraph_tpu_torch.config import Config, LidarConfig
from crowdnav_prediction_attngraph_tpu_torch.env import lidar


def make_cfg(angular_res=5.0, rng=10.0):
    return Config(lidar=LidarConfig(angular_res=angular_res, range=rng))


def t(*a):
    return torch.tensor(*a, dtype=torch.float32)


def test_ray_count_and_default_range():
    cfg = make_cfg()
    assert lidar.num_rays(cfg) == 72
    out = lidar.scan(cfg, torch.zeros(2), t(0.0), torch.zeros(0, 2),
                     torch.zeros(0), torch.zeros(0))
    # no humans -> every ray returns max range
    assert out.shape == (72,)
    np.testing.assert_allclose(out.numpy(), 10.0)


def test_head_on_hit_distance():
    cfg = make_cfg(angular_res=90.0)  # rays at 0, 90, 180, 270 degrees
    out = lidar.scan(cfg, torch.zeros(2), t(0.0), t([[3.0, 0.0]]), t([0.5]),
                     torch.ones(1)).numpy()
    # ray 0 (+x) hits the circle boundary at 2.5 m; others miss
    np.testing.assert_allclose(out[0], 2.5, atol=1e-6)
    np.testing.assert_allclose(out[1:], 10.0)


def test_heading_rotates_frame():
    cfg = make_cfg(angular_res=90.0)
    # robot facing +y: ray 0 points at the human
    out = lidar.scan(cfg, torch.zeros(2), t(np.pi / 2), t([[0.0, 4.0]]),
                     t([1.0]), torch.ones(1)).numpy()
    np.testing.assert_allclose(out[0], 3.0, atol=1e-5)


def test_masked_and_behind_humans_ignored():
    cfg = make_cfg(angular_res=90.0)
    # first human masked out; second is behind ray 0 but in front of ray 2
    out = lidar.scan(cfg, torch.zeros(2), t(0.0),
                     t([[3.0, 0.0], [-2.0, 0.0]]), t([0.5, 0.5]),
                     t([0.0, 1.0])).numpy()
    np.testing.assert_allclose(out[0], 10.0)
    np.testing.assert_allclose(out[2], 1.5, atol=1e-6)


def test_batched_shapes():
    cfg = make_cfg()
    B, A = 4, 6
    rng = np.random.RandomState(0)
    out = lidar.scan(cfg, t(rng.randn(B, 2)), t(rng.randn(B)),
                     t(rng.randn(B, A, 2) * 3), torch.full((B, A), 0.3),
                     torch.ones(B, A)).numpy()
    assert out.shape == (B, 72)
    assert np.all(out > 0) and np.all(out <= 10.0)


def test_range_clip():
    cfg = make_cfg(angular_res=90.0, rng=2.0)
    out = lidar.scan(cfg, torch.zeros(2), t(0.0), t([[5.0, 0.0]]), t([0.5]),
                     torch.ones(1))
    np.testing.assert_allclose(out.numpy(), 2.0)  # hit at 4.5 m: beyond range


def scan_f64(arrs, R=72, max_range=10.0):
    """The scan in float64 NumPy: (ranges, per-ray rounding bound)."""
    rp, th, hp, hr, hm = (a.astype(np.float64) for a in arrs)
    ang = th[..., None] + np.arange(R) * (2 * np.pi / R)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    rel = hp - rp[..., None, :]
    tt = np.einsum("...rk,...ak->...ra", d, rel)
    c2 = np.broadcast_to((rel * rel).sum(-1)[..., None, :], tt.shape)
    arg = (hr * hr)[..., None, :] - (c2 - tt * tt)
    hit_t = tt - np.sqrt(np.maximum(arg, 0.0))
    valid = (arg >= 0) & (hit_t > 0) & (hm[..., None, :] > 0)
    ranges = np.where(valid, hit_t, max_range)
    if ranges.shape[-1] == 0:
        return np.full(th.shape + (R,), max_range), np.full(th.shape + (R,),
                                                            1e-6)
    near = ranges.argmin(-1)[..., None]
    out = np.minimum(np.take_along_axis(ranges, near, -1)[..., 0], max_range)
    hit = out < max_range
    c2_n = np.take_along_axis(c2, near, -1)[..., 0]
    arg_n = np.take_along_axis(arg, near, -1)[..., 0]
    eps = np.finfo(np.float32).eps
    bound = 1e-6 + np.where(
        hit, 4 * eps * c2_n / np.sqrt(np.maximum(arg_n, 1e-12)), 0.0)
    return out, bound


@pytest.mark.parametrize("A", [7, 0])
def test_scan_matches_jax(A):
    rng = np.random.RandomState(3 + A)
    lead = (3, 4)
    arrs = [rng.uniform(-2, 2, lead + (2,)), rng.uniform(-np.pi, np.pi, lead),
            rng.uniform(-6, 6, lead + (A, 2)), rng.uniform(0.2, 0.8, lead + (A,)),
            (rng.uniform(size=lead + (A,)) > 0.3).astype(np.float32)]
    arrs = [a.astype(np.float32) for a in arrs]
    expect = np.asarray(jlidar.scan(
        JConfig(lidar=JLidarConfig(angular_res=5.0, range=10.0)),
        *[jnp.asarray(a) for a in arrs]))
    got = lidar.scan(make_cfg(), *[torch.from_numpy(a) for a in arrs]).numpy()
    truth, bound = scan_f64(arrs)
    assert got.shape == expect.shape == lead + (72,)
    miss = truth == 10.0
    np.testing.assert_allclose(got[miss], expect[miss], atol=1e-6)
    for name, a, b in (("port vs jax", got, expect),
                       ("port vs f64", got, truth),
                       ("jax vs f64", expect, truth)):
        err = np.abs(a - b)
        assert np.all(err <= bound), \
            f"{name}: {err.max()} over the bound at {np.argmax(err - bound)}"
    if A:
        assert (~miss).sum() > 50          # plenty of rays hit a human
