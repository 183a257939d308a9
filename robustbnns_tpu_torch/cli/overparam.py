"""Overparametrized-limit figure (port of ``robustbnns_tpu/cli/overparam.py``;
reference ``plot_halfMoons_overparam.py`` main, ``:147-179``).

Example::

    python -m robustbnns_tpu_torch.cli.overparam --quick=True --device=cpu

Reads ``halfMoons_lossGrads_final_<test_points>.csv`` under ``--savedir``,
or builds it from the grid search's checkpoints and gradients when it is
missing or ``--rebuild=True`` (every cell of the sweep must then be trained:
``cli.grid_search_half_moons``), then draws the scatterplot.
"""
from __future__ import annotations

import argparse
import os

from robustbnns_tpu_torch.cli.common import boolean, setup_device
from robustbnns_tpu_torch.cli.grid_search_half_moons import QUICK_SWEEP, REFERENCE_SWEEP
from robustbnns_tpu_torch.config import resolve_rel_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Toy example on half moons")
    parser.add_argument("--test_points", default=100, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--savedir", default="DATA", type=str)
    parser.add_argument("--rebuild", default=False, type=boolean)
    parser.add_argument("--quick", default=False, type=boolean)
    return parser


def run(args) -> dict:
    """Read or build the rows; ``args`` is a parsed namespace or a list of
    flags. Returns the rows, the CSV's path, the hidden sizes to plot and
    whether the rows were built."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device)

    from robustbnns_tpu_torch.experiments.grid_search import grid_combinations
    from robustbnns_tpu_torch.experiments.overparam import (
        build_overparam_scatterplot_dataset,
        load_overparam_scatterplot_dataset,
        overparam_csv_path,
    )

    rel_path = resolve_rel_path(args.savedir)
    sweep = QUICK_SWEEP if args.quick else REFERENCE_SWEEP
    if args.quick:
        posterior_samples = [10]
    else:  # reference settings :150-161
        posterior_samples = [10, 20, 50] if args.rebuild else [250]
    csv = overparam_csv_path(args.test_points, rel_path)
    built = args.rebuild or not os.path.exists(csv)
    if built:
        rows = build_overparam_scatterplot_dataset(grid_combinations(**sweep), posterior_samples, args.test_points,
                                                   rel_path=rel_path, out_dir=rel_path, device=device)
    else:
        rows = load_overparam_scatterplot_dataset(args.test_points, rel_path)
    return {"rows": rows, "csv": csv, "built": built, "hidden_size": sweep["hidden_size"],
            "test_points": args.test_points}


def main(args) -> dict:
    """:func:`run`, then the scatterplot."""
    from robustbnns_tpu_torch.experiments.overparam import overparam_scatterplot

    result = run(args)
    result["plot"] = overparam_scatterplot(result["rows"], result["hidden_size"], result["test_points"], orient="h")
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
