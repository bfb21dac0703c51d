"""Tracing/profiling utilities (JAX package ``utils/profiling.py``; the
reference only logs wall-clock FPS, train.py:222-232).

- The span and counter registry. :func:`span` (a context manager) and
  :func:`spanned` (its decorator form) time a named block of the port;
  :func:`count` adds to a named integer counter. Both are off by default:
  then a span is one flag test that returns a shared null context and a
  counter does nothing. :func:`enable` turns them on; each span is then
  stamped with ``time.time_ns()`` at its start and ends that stamp plus its
  duration on the monotonic ``time.perf_counter_ns()`` (so a step of the
  wall clock moves no total), remembers its parent span and thread, and opens a ``torch.profiler.record_function``
  range ``crowdnav.<name>``, so the device ops launched inside it can be
  matched to it in a profiler trace. A span never synchronises the device:
  its host time includes whatever blocking read the block makes.
  :func:`snapshot` returns the raw spans, per-name count, total and self
  time (the duration less the part its child spans cover) and the
  counters, with the launch tally since the last :func:`reset` as
  ``k1.launches``, ``k2.launches``, ``k3.launches``, ``orca.launches`` and
  ``spawn.launches``; a kernel adds to a counter on the device through
  :func:`device_counter`, which only :func:`snapshot` reads; :func:`readings`
  puts a snapshot per env step, and :func:`per_step_table` prints it.
- The launch tally, always on: ``ops/_build.launch`` adds one to its
  kernel's name (:data:`LAUNCH_NAMES`) at every launch; :func:`launches`
  reads it and :func:`zero_launches` (or :func:`reset`) zeroes it.
- One clock: a Chrome trace that ``torch.profiler`` exports gives each
  event's ``ts`` in microseconds of the same Unix clock, less the trace's
  ``baseTimeNanoseconds``; :func:`trace_us` converts a span's stamp.
- ``PhaseTimer``: per-phase wall-clock with an optional device sync, a
  view of spans recorded in a registry of its own (always on).
- ``trace``: context manager around ``torch.profiler`` (CPU ops, and the
  CUDA kernels where there is a card) writing a Chrome trace (viewable in
  chrome://tracing, Perfetto or TensorBoard) to ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List

import torch

RANGE_PREFIX = "crowdnav."
# the kernels' names in the launch tally
LAUNCH_NAMES = ("k1", "k2", "k3", "orca", "spawn")


class Registry:
    """Closed spans and counters. Each registry keeps its own stack of open
    spans per thread, which gives a span its parent."""

    def __init__(self):
        self.spans: List[tuple] = []     # (id, name, start_ns, end_ns,
                                         #  parent id or None, thread id)
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._ids = itertools.count()
        self._local = threading.local()

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def reset(self):
        self.spans.clear()
        self.counters.clear()

    def totals(self) -> Dict[str, dict]:
        """{name: {"count", "total_s", "self_s"}} over the closed spans."""
        child_ns = collections.defaultdict(int)
        for _, _, t0, t1, parent, _ in self.spans:
            if parent is not None:
                child_ns[parent] += t1 - t0
        out: Dict[str, dict] = {}
        for sid, name, t0, t1, _, _ in self.spans:
            t = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += (t1 - t0) / 1e9
            t["self_s"] += (t1 - t0 - child_ns[sid]) / 1e9
        return out

    def snapshot(self) -> dict:
        counters = dict(self.counters)
        spans = [{"id": sid, "name": name, "start_ns": t0, "end_ns": t1,
                  "parent": parent, "thread": tid}
                 for sid, name, t0, t1, parent, tid in self.spans]
        return {"spans": spans, "totals": self.totals(),
                "counters": counters}


class _Span:
    __slots__ = ("registry", "name", "id", "parent", "start", "mono",
                 "range")

    def __init__(self, registry: Registry, name: str):
        self.registry, self.name = registry, name

    def __enter__(self):
        reg = self.registry
        stack = getattr(reg._local, "stack", None)
        if stack is None:
            stack = reg._local.stack = []
        self.id = next(reg._ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self.start = time.time_ns()
        self.mono = time.perf_counter_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = self.start + (time.perf_counter_ns() - self.mono)
        reg = self.registry
        reg._local.stack.pop()
        reg.spans.append((self.id, self.name, self.start, end, self.parent,
                          threading.get_ident()))
        return False


# --- the port's registry -----------------------------------------------------

_ON = False
_NULL = contextlib.nullcontext()
_REGISTRY = Registry()
# {(counter name, device): int32 tensor on the device}
_DEVICE_COUNTERS: Dict[tuple, torch.Tensor] = {}
_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCH_NAMES, 0)


def enable():
    global _ON
    _ON = True


def disable():
    global _ON
    _ON = False


def reset():
    """Forget the closed spans and the counters (the device counters are
    set to 0 on the device) and zero the launch tally."""
    _REGISTRY.reset()
    for t in _DEVICE_COUNTERS.values():
        t.zero_()
    zero_launches()


def launched(name: str):
    """Add one launch of kernel ``name`` to the tally (on or off)."""
    _LAUNCHES[name] += 1


def launches() -> Dict[str, int]:
    """{kernel name: launches since the last zeroing} of the tally."""
    return dict(_LAUNCHES)


def zero_launches():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def snapshot() -> dict:
    """``{"spans": [...], "totals": {...}, "counters": {...}}`` of the port's
    registry (see :meth:`Registry.snapshot`), with the launch tally as
    ``<name>.launches`` and each device counter added to the counter of its
    name (one blocking read of each)."""
    snap = _REGISTRY.snapshot()
    counters = snap["counters"]
    for name, n in _LAUNCHES.items():
        counters[f"{name}.launches"] = n
    for (name, _), t in _DEVICE_COUNTERS.items():
        counters[name] = counters.get(name, 0) + int(t.item())
    return snap


def device_counter(name: str, device):
    """While tracing is on, the int32 scalar on ``device`` that a kernel adds
    counter ``name`` into, without a host read (0 when first made, and after
    each :func:`reset`); None while tracing is off."""
    if not _ON:
        return None
    key = (name, torch.device(device))
    t = _DEVICE_COUNTERS.get(key)
    if t is None:
        t = _DEVICE_COUNTERS[key] = torch.zeros((), dtype=torch.int32,
                                                device=device)
    return t


def span(name: str):
    """A span ``name`` around the block while tracing is on; otherwise the
    shared null context."""
    if not _ON:
        return _NULL
    return _Span(_REGISTRY, name)


def spanned(name: str):
    """Decorator form of :func:`span`: each call is a span ``name`` while
    tracing is on (the flag is read at every call)."""
    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if not _ON:
                return func(*args, **kwargs)
            with _Span(_REGISTRY, name):
                return func(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n: int = 1):
    """Add ``n`` (a host int) to counter ``name`` while tracing is on."""
    if _ON:
        _REGISTRY.counters[name] += n


def trace_us(t_ns: int, base_ns: int) -> float:
    """A ``time.time_ns()`` stamp on a Chrome trace's clock: the trace's
    ``ts`` microseconds, given its ``baseTimeNanoseconds``."""
    return (t_ns - base_ns) / 1e3


def readings(snap: dict) -> dict:
    """A snapshot per env step (one batched ``crowd_sim.step``, counted by
    ``env.steps``): each span's calls, self and total ms (largest self time
    first) and each counter, and the readings of the layers: ``orca_ms``
    and ``auto_reset_ms`` (the ``env.orca`` and ``vec.auto_reset`` spans),
    ``env_step_ms``, ``orca_lp3_share`` (``orca.lp3_egos`` over
    ``orca.egos``, %), ``env_syncs`` (the ``sync.*`` counters),
    ``backward_ms`` (per ``ppo.backward`` call: one minibatch step),
    ``gst_graph`` (the GST's CUDA calls in all: ``captures``, ``replays``
    of a captured graph and ``eager`` calls run op by op),
    ``gst_graph_share`` (captures and replays over those calls, %) and
    ``gst_edge_rows`` (the edge selector's target rows, ``gst.edge_rows``,
    per ``gst.pretext`` call: B x A x (obs_len + pred_len - 1), 0 with
    full connectivity)."""
    tot, c = snap["totals"], snap["counters"]
    steps = c.get("env.steps", 0)
    n = max(steps, 1)
    gst = {k: c.get(f"gst.{name}", 0) for k, name in (
        ("captures", "graph_captures"), ("replays", "graph_replays"),
        ("eager", "eager"))}
    gst_calls = sum(gst.values())
    pretext = tot.get("gst.pretext", {}).get("count", 0)

    def ms(name, per):
        return tot[name]["total_s"] * 1e3 / per if name in tot else None
    return {
        "env_steps": steps,
        "orca_ms": ms("env.orca", n),
        "env_step_ms": ms("env.step", n),
        "auto_reset_ms": ms("vec.auto_reset", n),
        "orca_lp3_share": (100.0 * c.get("orca.lp3_egos", 0) / c["orca.egos"]
                           if c.get("orca.egos") else None),
        "env_syncs": sum(v for k, v in c.items()
                         if k.startswith("sync.")) / n,
        "backward_ms": (ms("ppo.backward", tot["ppo.backward"]["count"])
                        if "ppo.backward" in tot else None),
        "gst_graph": gst,
        "gst_graph_share": (100.0 * (gst["captures"] + gst["replays"])
                            / gst_calls if gst_calls else None),
        "gst_edge_rows": (c["gst.edge_rows"] / pretext
                          if pretext and "gst.edge_rows" in c else None),
        "spans_per_step": {
            name: {"calls": t["count"] / n, "self_ms": t["self_s"] * 1e3 / n,
                   "total_ms": t["total_s"] * 1e3 / n}
            for name, t in sorted(tot.items(),
                                  key=lambda kv: -kv[1]["self_s"])},
        "counters_per_step": {k: v / n for k, v in sorted(c.items())},
    }


def per_step_table(snap: dict) -> str:
    """The operator's table of a snapshot (see :func:`readings`): each
    span's calls, self and total ms per env step, then each counter per env
    step, then the GST's calls in all and its edge rows a pretext call,
    where there were any."""
    r = readings(snap)
    lines = [f"{'span':<22}{'calls/step':>11}{'self ms/step':>14}"
             f"{'total ms/step':>15}"]
    for name, t in r["spans_per_step"].items():
        lines.append(f"{name:<22}{t['calls']:>11.3f}{t['self_ms']:>14.3f}"
                     f"{t['total_ms']:>15.3f}")
    lines.append(f"{'counter':<22}{'per step':>11}")
    for name, v in r["counters_per_step"].items():
        lines.append(f"{name:<22}{v:>11.3f}")
    pretext = snap["totals"].get("gst.pretext", {}).get("count", 0)
    if r["gst_graph_share"] is not None or pretext:
        g = r["gst_graph"]
        line = (f"gst graph: {g['captures']} captures, {g['replays']} "
                f"replays, {g['eager']} eager; {pretext} pretext calls")
        if r["gst_graph_share"] is not None:
            line += f"; share {r['gst_graph_share']:.1f}%"
        if r["gst_edge_rows"] is not None:
            line += f"; {r['gst_edge_rows']:.1f} edge rows a pretext call"
        lines.append(line)
    return "\n".join(lines)


# --- phases and traces -------------------------------------------------------

class PhaseTimer:
    """Per-phase wall-clock totals over spans of a registry of its own."""

    def __init__(self):
        self.registry = Registry()

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block as a span; with ``sync`` (a CUDA device) the
        device's queued work is waited for before the span closes (the CPU
        has none)."""
        with self.registry.span(name):
            yield
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)

    @property
    def totals(self) -> Dict[str, float]:
        return {k: t["total_s"] for k, t in self.registry.totals().items()}

    @property
    def counts(self) -> Dict[str, int]:
        return {k: t["count"] for k, t in self.registry.totals().items()}

    def report(self) -> str:
        lines = []
        counts = self.counts
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = counts[name]
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
