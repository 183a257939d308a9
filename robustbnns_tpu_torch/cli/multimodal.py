"""Posterior multimodality (port of ``robustbnns_tpu/cli/multimodal.py``;
reference ``test_multimodal.py``).

Example::

    python -m robustbnns_tpu_torch.cli.multimodal --debug=True --n_samples=5 --device=cpu

Trains (or, with ``--load_model=True``, loads) one full-batch HMC chain of
``multimodal_BNNs["model_<idx>"]`` per training-set size (1,000, 10,000 and
60,000 points; 100 with ``--debug``), projects ``--n_samples`` draws of each
and 1,000 prior draws to 2-D, writes the rows to
``<DATA>/<name>/<dataset>_<arch>_hmc_<sep|same>PCA.csv`` and plots them.
``--plot_only=True`` reads that file when it exists.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from robustbnns_tpu_torch.cli.common import boolean, setup_device, timed
from robustbnns_tpu_torch.config import multimodal_BNNs, resolve_rel_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_idx", default=10, type=int, help="10, 11 (HMC only)")
    parser.add_argument("--n_samples", default=50, type=int)
    parser.add_argument("--load_model", default=False, type=boolean)
    parser.add_argument("--plot_only", default=False, type=boolean)
    parser.add_argument("--same_pca", default=False, type=boolean)
    parser.add_argument("--debug", default=False, type=boolean)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--hmc_sampler", default="hmc", type=str, help="hmc, nuts")
    parser.add_argument("--hmc_init", default="random", type=str, help="random, map")
    return parser


def run(args) -> dict:
    """Build (or read) the rows and write the CSV; ``args`` is a parsed
    namespace or a list of flags. Returns the rows, the CSV's path, the
    training-set sizes, the plot's file name and the build's seconds."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device)

    from robustbnns_tpu_torch.experiments.multimodal import build_multimodal_df
    from robustbnns_tpu_torch.experiments.tables import read_rows, write_rows

    cfg = dataclasses.replace(multimodal_BNNs[f"model_{args.model_idx}"], n_samples=args.n_samples)
    n_inputs_list = [100] if args.debug else [1000, 10000, 60000]  # reference :33
    data = resolve_rel_path("DATA")
    rel_path = os.path.join(data, "debug/") if args.debug else data
    plot_filename = f"{cfg.dataset}_{cfg.architecture}_{cfg.inference}" + ("_samePCA" if args.same_pca else "_sepPCA")
    csv_path = os.path.join(rel_path, cfg.name(), plot_filename + ".csv")
    result = {"csv": csv_path, "n_inputs_list": n_inputs_list, "plot_filename": plot_filename}
    if args.plot_only and os.path.exists(csv_path):
        result["rows"] = read_rows(csv_path, index_col=0)
        return result
    result["rows"], result["build_seconds"] = timed(device, lambda: build_multimodal_df(
        cfg, n_inputs_list, n_samples=args.n_samples, rel_path=rel_path, train=not args.load_model,
        same_pca=args.same_pca, hmc_sampler=args.hmc_sampler, hmc_init=args.hmc_init, device=device))
    write_rows(csv_path, result["rows"], index=True)
    return result


def main(args) -> dict:
    """:func:`run`, then the KDE plot."""
    from robustbnns_tpu_torch.experiments.multimodal import plot_multimodal_kde

    result = run(args)
    result["plot"] = plot_multimodal_kde(result["rows"], result["n_inputs_list"], result["plot_filename"])
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
