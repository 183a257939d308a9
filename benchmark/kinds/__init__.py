"""Traffic kinds. A traffic file's ``kind`` names the module here that drives it.

Each module has a ``Cell(spec, seed, device)`` whose constructor is the
set-up (the program built, the inputs made, every shape warmed up), and
whose methods are ``window(seconds)`` (the measured window: whole units of
work back to back until the first one that ends after ``seconds``),
``stretch()`` (a short run of the same work for the profiler, after the
window), ``release()`` (the program's state freed, what the check needs
kept) and ``check(candidate)`` (the numbers that decide ``correct``).
"""
from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
