"""The traced run: host spans around the port's layers, and one
``torch.profiler`` trace of a slice of the window, reduced to device
numbers.

:class:`Spans` wraps the port's layer functions (through ``port.wrap``):
each call is timed by the host clock between two ``torch.cuda.synchronize``
calls and opens a ``torch.profiler.record_function`` range
``bench.<layer>``, so the trace can say which layer launched a kernel and
what the host was doing while the device idled. It also counts the rows
each layer processed, for the FLOP count of ``mfu``.

:class:`Tracer` records a slice of the window: the driver (or a span)
calls :meth:`Tracer.tick` at each unit of work (an iteration, an env step,
a gym step); ticks ``skip + 1`` to ``skip + 1 + active`` bound the slice.
The profiler set-up is the one of the port's ``utils/profiling.trace`` (CPU
and CUDA activities), with a schedule. The Chrome trace it writes goes to
``TMPDIR`` and is deleted once :func:`summarize` has read it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_PREFIX = "bench."


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Synchronised host times, row counts and call shapes per layer."""

    def __init__(self, device, tracer: Optional["Tracer"] = None):
        self.device = device
        self.tracer = tracer
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        self.rows: Dict[str, int] = collections.defaultdict(int)
        self.calls: Dict[str, list] = collections.defaultdict(list)

    def reset(self):
        """Forget what set-up recorded: the readings are the window's."""
        self.seconds.clear()
        self.rows.clear()
        self.calls.clear()

    def _keeps(self) -> bool:
        """Times and rows are kept before the profiler starts: once it has,
        its activity tracing slows every launch."""
        return self.tracer is None or self.tracer.before_profile

    def timed(self, layer: str, rows: Optional[Callable] = None,
              tick: bool = False):
        """A wrapper maker for ``port.wrap``: times each call of the layer,
        adds ``rows(args, kwargs)`` to its row count, and with ``tick``
        ticks the tracer before the call."""
        def make(func):
            def wrapper(*args, **kwargs):
                if tick and self.tracer is not None:
                    self.tracer.tick()
                _sync(self.device)
                t0 = time.perf_counter()
                with torch.profiler.record_function(RANGE_PREFIX + layer):
                    out = func(*args, **kwargs)
                _sync(self.device)
                if self._keeps():
                    self.seconds[layer].append(time.perf_counter() - t0)
                    if rows is not None:
                        self.rows[layer] += int(rows(args, kwargs))
                return out
            return wrapper
        return make

    def counted(self, layer: str, rows: Callable):
        """A wrapper maker that only adds ``rows(args, kwargs)`` to the
        layer's row count (no synchronisation, no range)."""
        def make(func):
            def wrapper(*args, **kwargs):
                if self._keeps():
                    self.rows[layer] += int(rows(args, kwargs))
                return func(*args, **kwargs)
            return wrapper
        return make

    def shaped(self, layer: str, shape: Callable):
        """A wrapper maker for a kernel's entry: no synchronisation, a
        range ``bench.<layer>``, and ``shape(args)`` kept for each call made
        while the tracer records."""
        def make(func):
            def wrapper(*args, **kwargs):
                with torch.profiler.record_function(RANGE_PREFIX + layer):
                    out = func(*args, **kwargs)
                if self.tracer is not None and self.tracer.recording:
                    self.calls[layer].append(shape(args, kwargs))
                return out
            return wrapper
        return make


class Tracer:
    """``torch.profiler`` over ticks ``skip + 1`` .. ``skip + 1 + active``
    (tick ``skip`` starts its warm-up). The trace is read after the window
    has closed, so that writing and reading it takes no time from it."""

    def __init__(self, device, skip: int, active: int):
        self.device = device
        self.skip, self.active = skip, active
        self.n = 0
        self.t_window = self.t_warm = self.t_start = self.t_end = None
        self.summary: Optional["TraceSummary"] = None
        self._saved = False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=skip, warmup=1,
                                             active=active, repeat=1),
            on_trace_ready=self._ready)
        self._entered = False

    @property
    def recording(self) -> bool:
        return self.skip + 1 <= self.n < self.skip + 1 + self.active

    @property
    def before_profile(self) -> bool:
        return self.n < self.skip

    def start(self):
        self.prof.__enter__()
        self._entered = True
        self.t_window = time.perf_counter()

    def tick(self):
        if not self._entered:
            return
        _sync(self.device)
        now = time.perf_counter()
        self.n += 1
        if self.n == self.skip:
            self.t_warm = now
        elif self.n == self.skip + 1:
            self.t_start = now
        elif self.n == self.skip + 1 + self.active:
            self.t_end = now
        self.prof.step()

    def stop(self):
        if self._entered:
            self._entered = False
            self.prof.__exit__(None, None, None)

    def read(self):
        """Read the trace of the slice, once the window has closed."""
        if not self._saved:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.summary = summarize(path)
        finally:
            os.remove(path)

    def _ready(self, prof):
        self._saved = True

    @property
    def before_s(self) -> Optional[float]:
        """Seconds from the window's start to the profiler's warm-up: the
        part of the window the spans and rows were kept in."""
        if self.t_window is None or self.t_warm is None:
            return None
        return self.t_warm - self.t_window

    @property
    def window_s(self) -> Optional[float]:
        if self.t_start is None or self.t_end is None:
            return None
        return self.t_end - self.t_start


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    ops: List[Tuple[str, float]]        # device time by op name, largest first
    range_time: Dict[str, float]        # device seconds launched in a range
    range_ops: Dict[str, int]           # device ops launched in a range
    range_calls: Dict[str, int]         # number of ranges of each name
    idle: List[Tuple[str, float]]       # idle seconds by the host's range


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost_labels(ranges: List[Tuple[float, float, str]]):
    """Boundaries and labels of the innermost range in force along one
    thread's timeline (ranges on a thread nest)."""
    points = []
    for s, e, name in ranges:
        points.append((s, 1, e, name))
        points.append((e, 0, s, name))
    points.sort(key=lambda p: (p[0], p[1]))
    stack: List[str] = []
    times, labels = [], []
    for t, is_start, _, name in points:
        if is_start:
            stack.append(name)
        elif name in stack:
            # remove the last occurrence of this range
            idx = len(stack) - 1 - stack[::-1].index(name)
            stack.pop(idx)
        times.append(t)
        labels.append(stack[-1] if stack else "no bench range")
    return times, labels


def summarize(path: str) -> TraceSummary:
    """Device busy time, device time and op count by the ``bench.`` range
    that launched each op (matched by correlation id to the launch on the
    host, then by time to the ranges open on that thread), and idle time by
    the host's innermost ``bench.`` range."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, launches, ranges = [], {}, collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(ev)
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), float(ev["ts"]))
        elif cat == "user_annotation" and \
                str(ev.get("name", "")).startswith(RANGE_PREFIX):
            s = float(ev["ts"])
            ranges[ev.get("tid")].append(
                (s, s + float(ev.get("dur", 0.0)),
                 ev["name"][len(RANGE_PREFIX):]))

    intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in dev]
    merged = _union(intervals)
    busy_us = sum(e - s for s, e in merged)
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[str(e.get("name", ""))[:160]] += float(e.get("dur", 0.0)) / 1e6

    # ranges of each name on each thread, sorted, for the launch lookup
    index = {}
    range_calls = collections.Counter()
    for tid, rs in ranges.items():
        by = collections.defaultdict(list)
        for s, e, name in rs:
            by[name].append((s, e))
            range_calls[name] += 1
        index[tid] = {n: (sorted(v), [a for a, _ in sorted(v)])
                      for n, v in by.items()}
    range_time = collections.defaultdict(float)
    range_ops = collections.defaultdict(int)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        hit = launches.get(corr)
        if hit is None:
            continue
        tid, t = hit
        for name, (spans, starts) in index.get(tid, {}).items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                range_time[name] += float(e.get("dur", 0.0)) / 1e6
                range_ops[name] += 1

    # idle gaps between device ops, by the innermost range of the thread
    # with the most ranges (the one that drives the port)
    idle = collections.defaultdict(float)
    if ranges and len(merged) > 1:
        main = max(ranges, key=lambda t: len(ranges[t]))
        times, labels = _innermost_labels(ranges[main])
        for (s0, e0), (s1, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(times, e0) - 1
            label = labels[i] if i >= 0 else "no bench range"
            idle[label] += (s1 - e0) / 1e6
    return TraceSummary(
        busy_s=busy_us / 1e6,
        ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        range_time=dict(range_time), range_ops=dict(range_ops),
        range_calls=dict(range_calls),
        idle=sorted(idle.items(), key=lambda kv: -kv[1]))
