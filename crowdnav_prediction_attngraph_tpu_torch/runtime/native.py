"""ctypes binding for the native ORCA engine (``runtime/orca_engine.cc``,
a byte-for-byte copy of the JAX package's).

The first call builds the shared library with ``g++ -O2 -shared -fPIC``
into the port's build directory ``<repo>/.torch_build/`` (beside the CUDA
kernels of ``ops/_build.py``), under a name that carries the hash of the
source and the flags; nothing is written beside the source. A failed build
raises. The engine is an independent float64 oracle for the batched
``env/orca.py`` and a host crowd stepper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..ops._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "orca_engine.cc")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"liborca_engine_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the engine unless an up-to-date library exists; returns its
    path. Raises RuntimeError with g++'s output if the build fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native "
                           "ORCA engine")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    up = ctypes.POINTER(ctypes.c_ubyte)
    lib.orca_velocity.argtypes = [dp, dp, ctypes.c_double, ctypes.c_double,
                                  dp, dp, dp, dp, up, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, dp]
    lib.orca_velocity.restype = None
    lib.orca_crowd_step.argtypes = [ctypes.c_int, dp, dp, dp, dp, dp,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double]
    lib.orca_crowd_step.restype = None
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a, shape):
    a = np.ascontiguousarray(a, np.float64)
    if a.shape != shape:
        raise ValueError(f"expected shape {shape}, got {a.shape}")
    return a


def orca_velocity_native(ego_pos, ego_vel, ego_radius, max_speed, pref_vel,
                         nbr_pos, nbr_vel, nbr_radius, nbr_mask, time_step,
                         time_horizon, neighbor_dist) -> np.ndarray:
    """New ORCA velocity (2,) of one ego among N masked neighbours; radii
    pre-inflated by the caller."""
    lib = load()
    n = len(nbr_radius)
    ego_pos = _f64(ego_pos, (2,))
    ego_vel = _f64(ego_vel, (2,))
    pref_vel = _f64(pref_vel, (2,))
    nbr_pos = _f64(nbr_pos, (n, 2))
    nbr_vel = _f64(nbr_vel, (n, 2))
    nbr_radius = _f64(nbr_radius, (n,))
    nbr_mask = np.ascontiguousarray(nbr_mask, np.uint8)
    if nbr_mask.shape != (n,):
        raise ValueError(f"expected mask shape {(n,)}, got {nbr_mask.shape}")
    out = np.zeros(2, np.float64)
    lib.orca_velocity(
        _dp(ego_pos), _dp(ego_vel), float(ego_radius), float(max_speed),
        _dp(pref_vel), _dp(nbr_pos), _dp(nbr_vel), _dp(nbr_radius),
        nbr_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n,
        float(time_step), float(time_horizon), float(neighbor_dist),
        _dp(out))
    return out


def orca_crowd_step_native(pos, vel, radius, v_pref, goal, safety_space,
                           time_step, time_horizon, neighbor_dist):
    """One ORCA step of a crowd of n agents, each heading for its goal;
    returns the updated (pos (n, 2), vel (n, 2)) as new arrays."""
    lib = load()
    n = len(radius)
    pos = np.array(pos, np.float64, order="C")
    vel = np.array(vel, np.float64, order="C")
    if pos.shape != (n, 2) or vel.shape != (n, 2):
        raise ValueError(f"expected pos and vel of shape {(n, 2)}")
    radius = _f64(radius, (n,))
    v_pref = _f64(v_pref, (n,))
    goal = _f64(goal, (n, 2))
    lib.orca_crowd_step(n, _dp(pos), _dp(vel), _dp(radius), _dp(v_pref),
                        _dp(goal), float(safety_space), float(time_step),
                        float(time_horizon), float(neighbor_dist))
    return pos, vel
