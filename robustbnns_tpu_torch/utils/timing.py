"""Timing and profiling helpers (port of ``robustbnns_tpu/utils/timing.py``).

The reference's only instrumentation is a wall-clock print (reference
``utils.py:15-18``), kept for log parity; :class:`Timer` and
:func:`maybe_profile` are the JAX package's additions, over
``torch.cuda.synchronize`` and ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def execution_time(start: float, end: float) -> str:
    """Format + print elapsed wall-clock time (reference ``utils.py:15-18``)."""
    hours, rem = divmod(end - start, 3600)
    minutes, seconds = divmod(rem, 60)
    msg = "\nExecution time = {:0>2}:{:0>2}:{:0>2}".format(int(hours), int(minutes), int(seconds))
    print(msg)
    return msg


class Timer:
    """Wall-clock seconds of a block in ``elapsed``; where the process uses a
    card, the card's queued work is finished before the clock is read."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._start: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._start


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the host and, where there is
    one, the card) into a Chrome trace file under ``trace_dir`` when it is
    given; yield the profiler, or ``None`` without a ``trace_dir``."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        yield prof
