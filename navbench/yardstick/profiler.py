"""The device trace of a call, read from `torch.profiler`.

The reading follows `scripts/profile_torch_solve.profiled` (frozen here):
device time is summed over the device's own events (kernels, memcpy,
memset) and kernels are counted by name.  Beyond it, this module merges the device events
into busy intervals (so that overlapping events count once), and names the
idle gaps between them by the innermost host operation that was running at
each gap's middle.  `host=False` traces the device alone: the profiler
keeps every event in memory, and the host's events of a call with millions
of operators may not fit.
"""
from __future__ import annotations

import time
from collections import defaultdict

def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(cpu_events, points):
    """For each time in `points` (ascending), the name of the innermost
    host event of `cpu_events` (sorted by start, properly nested) that
    spans it, or "host (between operators)"."""
    names, stack, i = [], [], 0
    for t in points:
        while i < len(cpu_events) and cpu_events[i][0] <= t:
            s, e, name = cpu_events[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host (between operators)")
    return names


def _annotation(e) -> bool:
    """Whether a raw event is an annotation, where this torch tells."""
    for attr in ("is_user_annotation", "activity_type"):
        f = getattr(e, attr, None)
        if f is not None:
            v = f()
            return v if isinstance(v, bool) else "annotation" in str(v)
    return False


def _events(prof):
    """(name, on_device, start_ns, duration_ns, thread, is_kernel) of every
    host event and device activity, read from the profiler's raw results:
    building its `FunctionEvent`s takes minutes for a million events.  An
    annotation on the device's timeline (such as the optimizer's step) is
    no activity: it spans kernels and would fill their gaps."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and _annotation(e):
            continue
        name = e.name()
        low = name.lower()
        yield (name, dev, e.start_ns(), e.duration_ns(),
               e.start_thread_id(),
               dev and "memcpy" not in low and "memset" not in low)


def trace(fn, host: bool = True, n_top: int = 10) -> dict:
    """Run `fn()` (which ends in a device synchronize) under the profiler
    and read its trace.  Returns:

    wall_s          host seconds of fn() under the profiler
    busy_s          seconds in which some device event ran
    kernel_events   number of device kernels (one per launch)
    kernel_calls    {name: [device seconds of each call, in time order]}
                    for names containing "spd_"
    device_ops      [[name, seconds]] of the n_top longest kernels by sum
    idle_gaps       [[host operation, idle seconds]], n_top by sum (host)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    if not torch.cuda.is_available():     # a rehearsal on the CPU
        acts = [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels = defaultdict(lambda: [0, 0.0])
    kernel_calls = defaultdict(list)
    intervals, cpu, n_kernels = [], [], 0
    threads = defaultdict(int)
    for name, dev, start, dur, thread, is_kernel in _events(prof):
        if dev:
            intervals.append((start, start + dur))
            k = kernels[name]
            k[0] += 1
            k[1] += dur / 1e9
            n_kernels += is_kernel
            if "spd_" in name:
                kernel_calls[name].append((start, dur / 1e9))
        elif host:
            threads[thread] += 1
            cpu.append((start, start + dur, name, thread))
    merged = _merge(intervals)
    busy = sum(e - s for s, e in merged) / 1e9
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    out = {
        "wall_s": wall, "busy_s": busy, "kernel_events": n_kernels,
        "kernel_calls": {k: [d for _, d in sorted(v)]
                         for k, v in kernel_calls.items()},
        "device_ops": [[k[:120], v[1]] for k, v in top[:n_top]],
        "idle_gaps": [],
    }
    if host and merged and cpu:
        main = max(threads, key=threads.get)
        # Outer operators first where two start together.
        cpu_main = sorted(((s, e, n) for s, e, n, t in cpu if t == main),
                          key=lambda x: (x[0], -x[1]))
        start = min(cpu_main[0][0], merged[0][0])
        end = max(max(e for _, e, _ in cpu_main), merged[-1][1])
        bounds = [start] + [x for iv in merged for x in iv] + [end]
        gaps = [(bounds[i], bounds[i + 1])
                for i in range(0, len(bounds) - 1, 2)
                if bounds[i + 1] > bounds[i]]
        mids = [(s + e) / 2 for s, e in gaps]
        by_name = defaultdict(float)
        for (s, e), name in zip(gaps, _innermost(cpu_main, mids)):
            by_name[name] += (e - s) / 1e9
        out["idle_gaps"] = [[k[:120], v] for k, v in sorted(
            by_name.items(), key=lambda kv: kv[1], reverse=True)[:n_top]]
    return out


def idle_percent(tr: dict | None):
    """100 (1 - busy / wall) of a trace, or None."""
    if tr is None or not tr["wall_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
