"""The program's own spans and counters, read from a second profiled stretch.

The program marks its layer boundaries with spans (``torch.profiler`` ranges
under ``robustbnns_tpu_torch.utils.timing.spans_on``) and counts its units
of work (``timing.counters``). :func:`profile_spans` runs a stretch of the
cell's work with spans on under the profiler and reduces the event list:

- each span's intervals, its total and its self time (its duration less
  what its child spans on its thread cover);
- the device's busy intervals (their union, as :mod:`benchmark.trace` takes
  them), and each idle gap between two of them put down to the innermost
  program span open at the gap's middle on any thread, or to ``(outside)``;
- the launch calls (``cudaLaunchKernel``, ``cuLaunchKernel`` and their
  variants) that start inside each span's intervals, on any thread (the
  backward's launches come from autograd's device thread while the
  ``predictive.backward`` span waits for it);
- the device time of the kernels launched by the ops inside ``conv_trunk``,
  linked by the profiler's correlation of each kernel to its launching op;
- the counters' deltas over the stretch, the per-unit denominators.

:func:`of` builds a fresh cell of the run's kind for that stretch (the run's
own cell is released before the metrics are read), once a run, and keeps
the result in ``ctx["spans"]``. A program without spans gives ``None``, and
so every metric that reads it.
"""
from __future__ import annotations

import argparse
import bisect
import heapq
import importlib
import sys
import time
from collections import defaultdict

import torch

from benchmark import inputs
from benchmark.kinds import sync
from benchmark.trace import _union

SPANS = ("attack.batch", "attack.iteration", "predictive.forward", "predictive.backward", "conv_trunk",
         "svi.step", "svi.draws", "svi.elbo.forward", "svi.elbo.backward", "svi.accuracy")
ADAM = ("Optimizer.zero_grad#Adam.zero_grad", "Optimizer.step#Adam.step")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
PREDICTIVE = ("predictive.forward", "predictive.backward", "conv_trunk")  # the forward's child last
OUTSIDE = "(outside)"
UNITS = {"pgd": "attack.iterations", "svi": "svi.steps"}


def self_times(spans: list) -> dict:
    """Seconds by span name of each span's duration less its children's.

    ``spans``: ``(name, start_ns, end_ns, thread)``. A span's children are
    the spans on its thread that it encloses and no other span between
    encloses; on one thread they do not overlap."""
    own = defaultdict(float)
    by_thread = defaultdict(list)
    for name, start, end, thread in spans:
        by_thread[thread].append((start, -end, name))
    for events in by_thread.values():
        open_ = []  # (end, name) of the spans enclosing the current one
        for start, neg_end, name in sorted(events):
            end = -neg_end
            while open_ and open_[-1][0] <= start:
                open_.pop()
            own[name] += 1e-9 * (end - start)
            if open_:
                own[open_[-1][1]] -= 1e-9 * (end - start)
            open_.append((end, name))
    return dict(own)


def idle_by_span(busy: list, spans: list) -> dict:
    """Idle seconds between the busy intervals, summed by the innermost span
    (the latest started) open at each gap's middle on any thread."""
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(busy, busy[1:]))
    order = sorted((start, end, name) for name, start, end, _ in spans)
    by_name, active, i = defaultdict(float), [], 0
    for mid, length in gaps:
        while i < len(order) and order[i][0] <= mid:
            heapq.heappush(active, (-order[i][0], order[i][1], order[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        by_name[active[0][2] if active else OUTSIDE] += 1e-9 * length
    return dict(by_name)


class Intervals:
    """The union of some intervals, asked which times fall inside it."""

    def __init__(self, intervals) -> None:
        self.merged = _union(sorted((start, end) for start, end in intervals))
        self.starts = [m[0] for m in self.merged]

    def __contains__(self, t) -> bool:
        j = bisect.bisect_right(self.starts, t) - 1
        return j >= 0 and t <= self.merged[j][1]


def linked_device_s(name: str, spans: list, ops: list, kernels: list) -> float:
    """Device seconds of the kernels launched by the ops inside the spans
    ``name``, on the span's thread. ``ops``: ``(start_ns, thread,
    correlation)`` of the host's ops and ranges; ``kernels``: ``(start_ns,
    end_ns, linked correlation)``, the correlation of the launching op."""
    by_thread = defaultdict(list)
    for span_name, start, end, thread in spans:
        if span_name == name:
            by_thread[thread].append((start, end))
    within = {thread: Intervals(iv) for thread, iv in by_thread.items()}
    ids = {corr for start, thread, corr in ops if thread in within and start in within[thread]}
    return sum(1e-9 * (end - start) for start, end, linked in kernels if linked in ids)


def reduce(spans: list, ops: list, launches: list, kernels: list, window_s: float, counters: dict) -> dict:
    """The stretch's events reduced to what the metrics read (module docstring)."""
    busy = _union(sorted((start, end) for start, end, _ in kernels))
    intervals = defaultdict(list)
    for name, start, end, _ in spans:
        intervals[name].append((start, end))
    within = {name: Intervals(iv) for name, iv in intervals.items()}
    return {
        "window_s": window_s,
        "busy_s": 1e-9 * sum(end - start for start, end in busy),
        "counters": counters,
        "count": {name: len(iv) for name, iv in intervals.items()},
        "total_s": {name: 1e-9 * sum(end - start for start, end in iv) for name, iv in intervals.items()},
        "self_s": self_times(spans),
        "idle_s": idle_by_span(busy, spans),
        "launches": {name: sum(t in union for t in launches) for name, union in within.items()},
        "launch_calls": len(launches),
        "conv_trunk_device_s": linked_device_s("conv_trunk", spans, ops, kernels),
    }


def profile_spans(fn, device) -> dict:
    """Run ``fn`` with the program's spans on under the profiler and reduce
    the events (:func:`reduce`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from robustbnns_tpu_torch.utils import timing

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _attempt in range(3):
        before = timing.counters()
        with timing.spans_on(), torch_profile(activities=activities) as prof:
            sync(device)
            start = time.perf_counter()
            fn()
            sync(device)
            window_s = time.perf_counter() - start
        after = timing.counters()
        events = prof.profiler.kineto_results.events()
        host = [e for e in events if e.device_type() == DeviceType.CPU]
        ranges = {e.name() for e in host if _annotation(e)}
        kernels = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.linked_correlation_id()) for e in events
                   if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 and not _annotation(e)
                   and e.name() not in ranges]
        if kernels or not cuda:
            break
        # A trace with no device event has been seen after good traces in one process: trace again.
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()) for e in host
             if e.name() in SPANS + ADAM]
    ops = [(e.start_ns(), e.start_thread_id(), e.correlation_id()) for e in host if e.linked_correlation_id() == 0]
    launches = [e.start_ns() for e in host if e.name().startswith(LAUNCH_CALLS)]
    counters = {name: after[name] - before.get(name, 0) for name in after if after[name] != before.get(name, 0)}
    return reduce(spans, ops, launches, kernels, window_s, counters)


def _annotation(event) -> bool:
    is_annotation = getattr(event, "is_user_annotation", None)
    return bool(is_annotation()) if is_annotation is not None else False


def _run_seed() -> int:
    """The run's ``--seed`` (``benchmark/run.py``'s argument), else 0."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_known_args(sys.argv[1:])[0].seed


def of(ctx: dict):
    """The spans stretch of this traced run: a fresh cell of its kind, built
    from the run's seed, its ``stretch`` profiled with spans on, once a run
    (kept in ``ctx["spans"]``). ``None`` without a first trace, or where the
    program has no spans."""
    if "spans" not in ctx:
        ctx["spans"] = _measure(ctx) if ctx["trace"] is not None else None
    return ctx["spans"]


def _measure(ctx: dict):
    from robustbnns_tpu_torch.utils import timing

    if not hasattr(timing, "spans_on"):
        return None
    device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = importlib.import_module(f"benchmark.kinds.{ctx['traffic']['kind']}")
    cell = kind.Cell({"config": ctx["config"], "traffic": ctx["traffic"]},
                     inputs.sub_seed(_run_seed(), "spans"), device)
    try:
        result = profile_spans(cell.stretch, device)
    finally:
        cell.release()
    print_table(result, ctx)
    return result


def units(ctx: dict):
    """The spans stretch's units of work by the program's counter
    (PGD iterations, SVI steps), or ``None``."""
    s = of(ctx)
    if s is None:
        return None
    n = s["counters"].get(UNITS[ctx["traffic"]["kind"]], 0)
    return n or None


def print_table(s: dict, ctx: dict) -> None:
    """The per-span table, per unit of the counters, on standard error."""
    n = s["counters"].get(UNITS[ctx["traffic"]["kind"]], 0)
    if not n:
        return
    trace = ctx["trace"]
    unit = UNITS[ctx["traffic"]["kind"]]
    print(f"spans: {n} {unit}; {1e3 * s['window_s'] / n:.4f} ms and idle "
          f"{100 * (1 - s['busy_s'] / s['window_s']):.3f}% a unit with spans on, "
          f"{1e3 * trace['window_s'] / trace['units']:.4f} ms and idle "
          f"{100 * (1 - trace['busy_s'] / trace['window_s']):.3f}% in the plain stretch", file=sys.stderr)
    print(f"spans: {'span':<36} {'count':>7} {'total ms':>10} {'self ms':>10} {'idle ms':>10} {'launches':>9}"
          " (per unit)", file=sys.stderr)
    for name in list(SPANS + ADAM) + [OUTSIDE]:
        if name not in s["count"] and name not in s["idle_s"]:
            continue
        print(f"spans: {name:<36} {s['count'].get(name, 0) / n:>7.3f} {1e3 * s['total_s'].get(name, 0) / n:>10.4f} "
              f"{1e3 * s['self_s'].get(name, 0) / n:>10.4f} {1e3 * s['idle_s'].get(name, 0) / n:>10.4f} "
              f"{s['launches'].get(name, 0) / n:>9.3f}", file=sys.stderr)
    print(f"spans: {s['launch_calls'] / n:.3f} launch calls a unit ({trace['launches'] / trace['units']:.3f} device "
          f"kernels in the plain stretch); conv_trunk's kernels {1e3 * s['conv_trunk_device_s'] / n:.4f} device ms a "
          f"unit; counters {s['counters']}", file=sys.stderr)
