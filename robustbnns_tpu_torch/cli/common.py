"""Shared CLI plumbing: flag parsing, device selection, data loading (port of
``robustbnns_tpu/cli/common.py``)."""
from __future__ import annotations

import argparse
import time

import torch

from robustbnns_tpu_torch.utils.device import resolve_device


def boolean(value: str) -> bool:
    """Parse the reference's ``type=eval`` booleans without evaluating code."""
    v = str(value).strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True/False, got {value!r}")


def setup_device(device: str, mesh: str | None = None) -> torch.device:
    """Map ``--device cuda|cpu`` to a ``torch.device`` with exact f32 products
    (:func:`.utils.device.resolve_device`).

    ``cuda`` on a machine without a card raises. Meshes (``--mesh``) wait for the
    parallelism slice.
    """
    if mesh is not None:
        raise NotImplementedError("--mesh is not ported yet (parallelism slice, ROADMAP.md)")
    return resolve_device(device)


def add_common_flags(parser: argparse.ArgumentParser, n_inputs_default=60000):
    parser.add_argument("--n_inputs", default=n_inputs_default, type=int, help="number of input points")
    parser.add_argument("--model_idx", default=0, type=int, help="choose idx from the model zoo")
    parser.add_argument("--train", default=True, type=boolean, help="train or load saved model")
    parser.add_argument("--test", default=True, type=boolean, help="evaluate on test data")
    parser.add_argument("--savedir", default="DATA", type=str, help="DATA, TESTS")
    parser.add_argument("--device", default="cuda", type=str, help="cuda, cpu")
    parser.add_argument(
        "--mesh", default=None, type=str,
        help="default device mesh, e.g. 4x2 (data x sample), 8, or auto",
    )
    return parser


def load_data(dataset: str, n_inputs, shuffle=True):
    """Dataset arrays + shape info; falls back to the synthetic surrogate, with a
    warning, where there is no local copy and no network."""
    from robustbnns_tpu_torch.data.datasets import load_dataset

    try:
        return load_dataset(dataset, n_inputs=n_inputs, shuffle=shuffle)
    except FileNotFoundError:
        print(
            f"WARNING: no local copy of {dataset!r} and no network — using the "
            "deterministic SYNTHETIC surrogate (identical shapes/ranges). "
            "Accuracy numbers are not comparable to the real dataset."
        )
        return load_dataset(dataset, n_inputs=n_inputs, shuffle=shuffle, fallback="synthetic")


def timed(device: torch.device, fn):
    """``fn()`` and its wall seconds between two synchronisations with the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0
