"""``torch.profiler`` over a short stretch of work, reduced to what the
per-layer readers and the result's ``breakdown`` need.

Device-busy time is the union of the intervals of the device events
(kernels, copies, fills; not the spans that ``record_function`` ranges such
as ``Optimizer.step`` leave on the device's timeline): overlapping events
count once, so busy time never exceeds the stretch (the rule of
``chip_smoke.profiled_device_ms``). An idle gap, between two busy
intervals, is put down to the innermost host op that was running at its
middle (the CUDA runtime's own calls and unnamed events left out), or to
``(no host op)``, the interpreter between ops.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch

from benchmark.kinds import sync

NO_HOST_OP = "(no host op)"


def _union(spans):
    """Merged ``(start, end)`` intervals of sorted spans."""
    merged = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _gaps_by_host_op(busy, host_events) -> dict:
    """Idle seconds between the busy intervals, summed by the host op running at each gap's middle."""
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(busy, busy[1:]))
    ops = sorted(host_events)
    by_name, active, i = defaultdict(float), [], 0
    for mid, length in gaps:
        while i < len(ops) and ops[i][0] <= mid:
            heapq.heappush(active, (-ops[i][0], ops[i][1], ops[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        by_name[active[0][2] if active else NO_HOST_OP] += 1e-6 * length
    return by_name


def profile(fn, device) -> dict:
    """Run ``fn`` (which returns its count of units) under the profiler.

    Returns ``units``, ``window_s`` (host seconds between two
    synchronisations), ``busy_s``, ``launches`` (device kernels),
    ``device_ops`` (seconds by device op name) and ``idle_gaps`` (seconds by
    host op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _attempt in range(3):
        with torch_profile(activities=activities) as prof:
            sync(device)
            start = time.perf_counter()
            units = fn()
            sync(device)
            window_s = time.perf_counter() - start
        events = prof.events()
        ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)}
        dev = [e for e in events if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
               and e.name not in ranges and not getattr(e, "is_user_annotation", False)]
        if dev or not cuda:
            break
        # A trace with no device event has been seen after good traces in one process: trace again.
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy = _union(spans)
    device_ops = defaultdict(float)
    for e in dev:
        device_ops[e.name] += 1e-6 * (e.time_range.end - e.time_range.start)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name and not e.name.startswith("cu")]
    return {
        "units": units,
        "window_s": window_s,
        "busy_s": 1e-6 * sum(end - start for start, end in busy),
        "launches": sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset"))),
        "device_ops": dict(device_ops),
        "idle_gaps": dict(_gaps_by_host_op(busy, host)),
    }


def top(seconds_by_name: dict, n: int = 10) -> list:
    return [[name, s] for name, s in sorted(seconds_by_name.items(), key=lambda kv: -kv[1])[:n]]
