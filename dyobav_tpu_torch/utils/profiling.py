"""Spans and counters of the port, recorded while torch's profiler runs.

The port's counterpart of `dyobav_tpu.utils.profiling`.  That module's
`StepTimer` and `device_trace` are not ported: nothing calls them.

A span (`span(name, like)`) marks one stage of the program: the
predictor's heat maps, net, factored stem and clustering, the escalated
solve's warm stage and ladder stages, a Newton iteration, a training
chunk.  It is on
exactly while torch's profiler records (`active()`): `torch.profiler.
profile`, `torch.autograd.profiler.emit_nvtx` and `emit_itt` all turn it
on.  Off, a span reads that one flag and returns a shared no-op context.
On, it enters `torch.profiler.record_function(name)`, so the stage sits in
the profiler's trace and under Nsight's NVTX ranges on the device's clock;
it reads the host clock, records a pair of timing CUDA events on the
current stream of the tensor `like`'s device when that is a CUDA device, and
snapshots the port's counters (`ops/engine.any_lane.syncs`,
`ops/engine.to_host.syncs`, `ops/spd.spd_solve.launches`,
`ops/stem.stem_expand_pool.launches`).  On exit it adds its count, host
seconds, event pair and counter deltas to a process-wide registry keyed
by name.

A span's device time runs from its start event to its end event: the time
the stage held the stream, idle left by the host's launches included.

One per-lane counter rides on spans: `lane_counter(name, like)` hands out a
zero int32 tensor of one entry a lane, which the caller adds to on the
device and which the innermost open span owns.  When that span exits, the
tensor is folded into a histogram on the device, so no sync is made.

`summary()` waits for the pending events, reads them and returns
`{name: {"count", "host_s", "device_s", <counter>: delta, <lane counter>:
{"p50", "p95", "max"}}}`, with `device_s` None where the span saw no CUDA
device.  `reset()` empties the registry.  An operator runs any entry point
under `torch.profiler.profile` (or `nsys profile` with `emit_nvtx`) and
calls `summary()` afterwards.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

COUNTERS = ("any_lane.syncs", "to_host.syncs", "spd_solve.launches",
            "stem_expand_pool.launches")
# Bins of a lane counter's histogram; values beyond the last bin land in it.
LANE_BINS = 4096
# Pending event pairs of a span name beyond which the finished ones fold.
_FOLD_AT = 256

_NOOP = contextlib.nullcontext()
_profiler = torch.autograd.profiler
_lock = threading.Lock()
_open = threading.local()
_registry: dict = {}


def active() -> bool:
    """Whether spans record: torch's profiler is recording."""
    return _profiler._is_profiler_enabled


def span(name: str, like: torch.Tensor):
    """A context that records the stage `name` while `active()`, timing
    the stream of `like`'s device."""
    if not active():
        return _NOOP
    return _Span(name, like.device)


def lane_counter(name: str, like: torch.Tensor):
    """A zero int32 tensor of `like.shape[0]` lanes on `like`'s device,
    owned by the innermost open span, or None when no span is open (or
    spans are off).  The caller adds each lane's count to it in place."""
    if not active() or not _stack():
        return None
    t = torch.zeros(like.shape[0], dtype=torch.int32, device=like.device)
    _stack()[-1].lanes.append((name, t))
    return t


def _stack() -> list:
    """This thread's open spans, innermost last."""
    return _open.__dict__.setdefault("stack", [])


def _counters():
    from ..ops.engine import any_lane, to_host
    from ..ops.spd import spd_solve
    from ..ops.stem import stem_expand_pool

    return (any_lane.syncs, to_host.syncs, spd_solve.launches,
            stem_expand_pool.launches)


class _Entry:
    """What the registry holds of one span name."""

    def __init__(self):
        self.count, self.host_ns = 0, 0
        self.device_s = None
        self.pending = []          # (start, end) CUDA events not yet read
        self.counters = [0] * len(COUNTERS)
        self.hists = {}            # lane counter -> {device: histogram}

    def fold(self, wait: bool):
        """Move finished event pairs into device_s; with `wait`, all of
        them, waiting for each end event."""
        done = 0
        for start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self.device_s = (self.device_s or 0.0) + start.elapsed_time(
                end) / 1e3
            done += 1
        del self.pending[:done]


class _Span:
    __slots__ = ("name", "device", "lanes", "rf", "events", "t0", "c0")

    def __init__(self, name, device):
        self.name, self.device = name, device
        self.lanes, self.events = [], None

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.c0 = _counters()
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        c1 = _counters()
        _stack().pop()
        with _lock:
            e = _registry.get(self.name)
            if e is None:
                e = _registry[self.name] = _Entry()
            e.count += 1
            e.host_ns += t1 - self.t0
            for i, (a, b) in enumerate(zip(self.c0, c1)):
                e.counters[i] += b - a
            if self.events is not None:
                e.pending.append(self.events)
                if len(e.pending) > _FOLD_AT:
                    e.fold(wait=False)
            for lane_name, t in self.lanes:
                hist = e.hists.setdefault(lane_name, {})
                h = hist.get(t.device)
                if h is None:
                    h = hist[t.device] = torch.zeros(
                        LANE_BINS, dtype=torch.int64, device=t.device)
                h.index_add_(0, t.clamp(0, LANE_BINS - 1).long(),
                             torch.ones_like(t, dtype=torch.int64))
        self.rf.__exit__(*exc)


def _quantiles(hist: np.ndarray) -> dict:
    values = np.repeat(np.arange(hist.shape[0]), hist)
    if values.size == 0:
        return {"p50": None, "p95": None, "max": None}
    return {"p50": float(np.percentile(values, 50)),
            "p95": float(np.percentile(values, 95)),
            "max": int(values.max())}


def summary() -> dict:
    """Every span name's count, host and device seconds, counter deltas and
    lane counters' 50th / 95th percentile and maximum over lanes."""
    with _lock:
        out = {}
        for name, e in _registry.items():
            e.fold(wait=True)
            s = {"count": e.count, "host_s": e.host_ns / 1e9,
                 "device_s": e.device_s}
            s.update(zip(COUNTERS, e.counters))
            for lane_name, hist in e.hists.items():
                s[lane_name] = _quantiles(sum(
                    h.cpu().numpy() for h in hist.values()))
            out[name] = s
        return out


def reset() -> None:
    """Empty the registry."""
    with _lock:
        _registry.clear()
