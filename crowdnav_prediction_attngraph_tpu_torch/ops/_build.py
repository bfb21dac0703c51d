"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes no
PyTorch headers, so it compiles with ``nvcc`` alone in seconds (a source that
includes ``torch/extension.h`` and goes through
``torch.utils.cpp_extension.load`` takes minutes, and needs ninja). The
shared library lands in ``<repo>/.torch_build/`` (listed in ``.gitignore``)
under a name that carries the hash of its source, the shared headers of
``csrc/`` (``*.cuh``) and the flags, so a changed source is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported: the
first call that needs a kernel builds it. :func:`kernel_fn`, :func:`ptrs` and
:func:`on_device` bind and call a library's C entries.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".torch_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns
    {name: ptxas report} (kept beside each library, so a source built
    earlier reports too); raises with nvcc's stderr if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, reports = {}, {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            report = target + ".ptxas.txt"
            if os.path.exists(report):
                with open(report) as f:
                    reports[name] = f.read()
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                          f"{out}{err}")
            continue
        with open(target + ".ptxas.txt", "w") as f:
            f.write(err)
        os.replace(tmp, target)
        reports[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name))
        _loaded[name] = lib
    return lib


# the C entries' argument types: pointers (and the stream) as c_void_p, so
# ctypes does not cut them to 32 bits
P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double

_fns = {}


def kernel_fn(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with the given argument
    types, the stream appended, returning an int (a cudaError)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes) + [P]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def ptrs(*tensors):
    """Data pointers for a C entry; None (an unused scratch) passes NULL."""
    return [None if t is None else t.data_ptr() for t in tensors]


def on_device(device):
    """The kernels launch on the current device: a context that makes
    ``device`` current, or nothing when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
