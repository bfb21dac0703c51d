"""The port's native ORCA engine (runtime/orca_engine.cc, a byte-for-byte
copy of the JAX package's, built with g++ into the port's build directory):

* the engine against the JAX package's float64 NumPy oracle and the port's
  copy of it, to atol 1e-9, over the 12 seeded scenes of
  tests/test_native_orca.py (the two oracles are held to each other
  exactly);
* the crowd step: 8 agents on an antipodal circle, 60 steps, no
  interpenetration, every agent closer to its goal;
* the port's batched ``orca_velocity_batch`` solved in float64 against the
  engine, to 5e-3 (tests/test_torch_orca.py's float64 bound);
* the build writes nothing under the package.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from crowdnav_prediction_attngraph_tpu.utils.orca_oracle import (
    orca_velocity_np as j_orca_velocity_np)
from crowdnav_prediction_attngraph_tpu_torch.env.orca import (
    orca_velocity_batch)
from crowdnav_prediction_attngraph_tpu_torch.runtime import native
from crowdnav_prediction_attngraph_tpu_torch.utils.orca_oracle import (
    orca_velocity_np)
from test_orca import random_scene

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

PACKAGE = os.path.dirname(os.path.dirname(native.__file__))
TIME_STEP, TIME_HORIZON, NEIGHBOR_DIST = 0.25, 5.0, 10.0


def test_cpp_matches_numpy_oracles():
    for seed in range(12):
        scene = random_scene(np.random.RandomState(seed), 10)
        args = (*scene, TIME_STEP, TIME_HORIZON, NEIGHBOR_DIST)
        expect = j_orca_velocity_np(*args)
        np.testing.assert_array_equal(orca_velocity_np(*args), expect)
        got = native.orca_velocity_native(
            *scene, np.ones(10, np.uint8), TIME_STEP, TIME_HORIZON,
            NEIGHBOR_DIST)
        np.testing.assert_allclose(got, expect, atol=1e-9,
                                   err_msg=f"seed={seed}")


def test_crowd_step_progresses_and_avoids():
    n = 8
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pos = np.stack([5 * np.cos(ang), 5 * np.sin(ang)], axis=1)
    goal = -pos.copy()
    vel = np.zeros((n, 2))
    radius = np.full(n, 0.3)
    v_pref = np.ones(n)
    d0 = np.linalg.norm(pos - goal, axis=1)
    for _ in range(60):
        pos, vel = native.orca_crowd_step_native(
            pos, vel, radius, v_pref, goal, 0.15, TIME_STEP, TIME_HORIZON,
            NEIGHBOR_DIST)
        gap = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        assert gap[np.triu_indices(n, 1)].min() > 0.55
    assert np.all(np.linalg.norm(pos - goal, axis=1) < d0)


def test_batched_float64_matches_engine():
    """48 egos among 12 masked neighbours each, packed enough that some take
    LP3; the port's batch in float64 against the engine per ego."""
    rng = np.random.RandomState(4)
    E, N = 48, 12
    scenes = [random_scene(rng, N, spread=3.0) for _ in range(E)]
    cols = [np.stack([s[i] for s in scenes]) for i in range(8)]
    mask = rng.uniform(size=(E, N)) > 0.15
    nd = rng.uniform(5, 10, E)
    got = orca_velocity_batch(
        *[torch.from_numpy(np.asarray(c, np.float64)) for c in cols],
        torch.from_numpy(mask), TIME_STEP, TIME_HORIZON,
        torch.from_numpy(nd)).numpy()
    expect = np.stack([native.orca_velocity_native(
        *[c[e] for c in cols], mask[e], TIME_STEP, TIME_HORIZON, nd[e])
        for e in range(E)])
    np.testing.assert_allclose(got, expect, atol=5e-3)


def test_build_writes_nothing_under_the_package(tmp_path, monkeypatch):
    def listing():
        return sorted(os.path.join(d, f) for d, _, fs in os.walk(PACKAGE)
                      for f in fs if "__pycache__" not in d)

    before = listing()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load()
    assert lib is not None
    assert os.path.dirname(native.library_path()) == str(tmp_path)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == [
        os.path.basename(native.library_path())]
    assert listing() == before
