"""Tracing/profiling utilities (JAX package ``utils/profiling.py``; the
reference only logs wall-clock FPS, train.py:222-232).

- ``PhaseTimer``: per-phase wall-clock with a device sync, accumulated into
  a report (rollout / gae / update / eval phases).
- ``trace``: context manager around ``torch.profiler`` (CPU ops, and the
  CUDA kernels where there is a card) writing a Chrome trace (viewable in
  chrome://tracing, Perfetto or TensorBoard) to ``log_dir``.
- ``env_steps_per_s`` and ``edges_per_s``: derived throughput numbers.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with ``sync`` (a CUDA device) the device's queued
        work is waited for before the clock stops (the CPU has none)."""
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.device(sync).type == "cuda":
            torch.cuda.synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:>16}: {total:8.3f}s total, "
                         f"{total / max(n, 1) * 1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler (CPU ops, and CUDA kernels when
    a card is present) into ``<log_dir>/trace.json``. Yields the profiler,
    whose ``events()`` may be read after the block."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def env_steps_per_s(num_envs: int, num_steps: int, seconds: float) -> float:
    return num_envs * num_steps / seconds


def edges_per_s(rows: int, num_agents: int, seconds: float) -> float:
    """Interaction-graph edge throughput of one attention pass."""
    return rows * num_agents * num_agents / seconds
