"""Timing, profiling and the program's spans and counters (port of
``robustbnns_tpu/utils/timing.py``).

The reference's only instrumentation is a wall-clock print (reference
``utils.py:15-18``), kept for log parity; :class:`Timer` and
:func:`maybe_profile` are the JAX package's additions, over
``torch.cuda.synchronize`` and ``torch.profiler``.

**Spans** mark the program's layer boundaries (:func:`span`). They are off
unless a block runs under :func:`spans_on` (as :func:`maybe_profile`'s does):
off, a span is one shared no-op context and calls nothing of the profiler;
on, it is a ``torch.profiler`` range, so a profiler running at the time keeps
it in its event list, on the clock of the device's events. A profiler alone
does not turn spans on. A span's request number (the batch's or the step's
running count) rides in the range's inputs, which a profiler with
``record_shapes=True`` keeps; a span given none takes its enclosing span's.

- ``attack.batch``: one batch of :func:`.attacks.gradient_attacks.attack`;
- ``attack.iteration``: one FGSM or PGD iteration, its predictive and the
  loop's own sign, projection and clamp;
- ``predictive.forward``: the predictive and its summed cross-entropy;
- ``predictive.backward``: the input gradient (``torch.autograd.grad``);
- ``conv_trunk``: the conv architectures' forward, ``cct7``'s included;
- ``resnet.stage1``, ``resnet.stage2``, ``resnet.stage3``: ``resnet20``'s
  three stages, inside ``conv_trunk``;
- ``cct.attention``: each call of :func:`.ops.attention.attention`, ``cct7``'s
  ``softmax(q·kᵀ·scale)·v`` of one encoder layer, inside ``conv_trunk``;
- ``svi.step``: one SVI step, its draws, ELBO step and accuracy;
- ``svi.draws``: the step's pull of its rows and its ELBO and accuracy noise;
- ``svi.elbo.forward``, ``svi.elbo.backward``: the ELBO loss, its backward;
- ``svi.accuracy``: the step's train-accuracy predictive.

Adam's own ranges (``Optimizer.zero_grad#Adam.zero_grad``,
``Optimizer.step#Adam.step``) are torch's, inside ``svi.step``.

**Counters** are process-wide integers, always on (:func:`count`,
:func:`counters`): ``attack.batches``, ``attack.iterations``, ``svi.steps``,
``sampled_dense.<wrapper>``, each sampled-dense kernel wrapper's launches,
and ``<kind>.fwd`` and ``<kind>.dgrad`` of each kind of grouped conv a
kernel computes (``grouped_conv.fwd``, the conv trunk's 5×5 kernel's;
``grouped_conv3x3.fwd`` and ``grouped_conv3x3.dgrad``, ResNet-20's 3×3
kernel's), each bumped by :func:`.ops.build.launch` after a launch that
succeeded and read by :func:`.ops.launch_counts`; ``resnet.forwards``, one a
``resnet20`` forward, and ``resnet.cudnn_convs``, its convolutions that
``F.conv2d`` ran rather than a hand-written kernel (1 a forward in f32 on
the card, 19 elsewhere); ``cct.forwards``, one a ``cct7`` forward, and
``cct.attention`` and ``cct.plain_attention``, its attention calls by route
(:mod:`.ops.attention`: the fused route on the card in f32, the plain route
elsewhere; 7 a forward).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
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
    with spans_on(), profile(activities=activities, record_shapes=True,
                             on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        yield prof


_COUNTERS: defaultdict = defaultdict(int)


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; returns its new total."""
    _COUNTERS[name] += n
    return _COUNTERS[name]


def counters() -> dict:
    """A copy of every counter."""
    return dict(_COUNTERS)


def reset_counters(prefix: str) -> None:
    """Zero every counter whose name starts with ``prefix``."""
    for name in _COUNTERS:
        if name.startswith(prefix):
            _COUNTERS[name] = 0


class _Off:
    """The span of a block while spans are off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


class _Span:
    """A ``torch.profiler`` range named ``name``, its request in its inputs."""

    __slots__ = ("name", "request", "handle")

    def __init__(self, name: str, request: Optional[int]) -> None:
        self.name, self.request, self.handle = name, request, None

    def __enter__(self) -> None:
        stack = _requests()
        if self.request is None and stack:
            self.request = stack[-1]
        stack.append(self.request)
        args = () if self.request is None else (self.request,)
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *args)

    def __exit__(self, *exc) -> bool:
        torch.autograd._record_function_with_args_exit(self.handle)
        _requests().pop()
        return False


_OFF = _Off()
_spans = 0
_local = threading.local()


def _requests() -> list:
    """This thread's requests of the spans open on it, innermost last."""
    if not hasattr(_local, "requests"):
        _local.requests = []
    return _local.requests


def span(name: str, request: Optional[int] = None):
    """A context that marks a block as the span ``name`` while spans are on
    (:func:`spans_on`), with ``request`` (or its enclosing span's); while
    they are off, a shared context that does nothing."""
    if not _spans:
        return _OFF
    return _Span(name, request)


@contextlib.contextmanager
def spans_on():
    """Spans on for the block (nested blocks count)."""
    global _spans
    _spans += 1
    try:
        yield
    finally:
        _spans -= 1
