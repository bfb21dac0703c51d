"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes no
PyTorch headers, so it compiles with ``nvcc`` alone in seconds (a source that
includes ``torch/extension.h`` and goes through
``torch.utils.cpp_extension.load`` takes minutes, and needs ninja). The
shared library lands in ``<repo>/.torch_build/`` (listed in ``.gitignore``)
under a name that carries the hash of its source, the shared headers of
``csrc/`` (``*.cuh``) and the flags, so a changed source is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported: the
first call that needs a kernel builds it. :func:`launch` is the one way to a
kernel: it checks and lays out the tensors, calls the C entry on the current
stream and counts the launch in the tally of ``utils/profiling``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, NamedTuple

import torch

from ..utils import profiling

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


# the C type of each scalar: a ctypes value (such as a c_float) keeps its
# own; pointers (a tensor's, NULL and the stream) pass as c_void_p, so
# ctypes does not cut them to 32 bits
P = ctypes.c_void_p
_C_TYPES = {int: ctypes.c_int, float: ctypes.c_double, type(None): P}
_fns: Dict[tuple, object] = {}


class Rows(NamedTuple):
    """A 2-D tensor argument whose rows need only be dense (a column slice
    of a wider tensor): passed as its pointer and its int64 row stride."""
    tensor: torch.Tensor


def _entry(kernel: str, symbol: str, tensors, scalars):
    """The C entry ``symbol`` of ``csrc/<kernel>.cu`` typed for
    :func:`launch`'s arguments, the stream last, returning an int (a
    cudaError)."""
    argtypes = []
    for t, _, _ in tensors:
        argtypes += (P, ctypes.c_int64) if type(t) is Rows else (P,)
    argtypes += [_C_TYPES.get(type(v)) or type(v) for v in scalars]
    fn = getattr(load(kernel), symbol)
    fn.argtypes = argtypes + [P]
    fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, symbol: str, tally: str, tensors, scalars=()):
    """One launch of the C entry ``symbol`` of ``csrc/<kernel>.cu`` on the
    current stream of the first tensor's card, counted as ``tally`` in the
    launch tally. ``tensors`` are (tensor, dtype, shape) each, in the
    entry's order: a tensor must have that dtype and shape and sit on the
    first one's CUDA device (else TypeError or ValueError naming its
    index), is made contiguous where it is not (so an output must be made
    contiguous: a copy would take its writes) and passes its pointer; None
    passes NULL, and a :class:`Rows` its pointer and row stride. The
    ``scalars`` follow: an int passes as a C int, a float as a double, a
    ctypes value as its type. Nothing is loaded or built before the checks
    pass; a launch that fails raises RuntimeError with its cudaError."""
    args, held = [], []
    for i, (t, dtype, shape) in enumerate(tensors):
        if t is None:
            args.append(None)
            continue
        rows = type(t) is Rows
        if rows:
            t = t.tensor
        if i == 0:
            device = t.device
        if t.dtype != dtype:
            raise TypeError(f"{symbol} argument {i} is {t.dtype}, not {dtype}")
        if t.shape != shape or t.device != device:
            raise ValueError(f"{symbol} argument {i} must be {tuple(shape)} "
                             f"on {device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if not (t.stride(-1) == 1 if rows else t.is_contiguous()):
            t = t.contiguous()
        held.append(t)     # a copy lives until the launch is queued
        args.append(t.data_ptr())
        if rows:
            args.append(t.stride(0))
    if device.type != "cuda":
        raise ValueError(f"{symbol} argument 0 is on {device}, not a card")
    fn = _fns.get((kernel, symbol))
    if fn is None:
        fn = _fns[kernel, symbol] = _entry(kernel, symbol, tensors, scalars)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, *scalars, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {rc}")
    profiling.launched(tally)
