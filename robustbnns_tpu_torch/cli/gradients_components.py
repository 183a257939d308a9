"""Gradient-components stripplot and vanishing-gradient heatmaps (port of
``robustbnns_tpu/cli/gradients_components.py``; reference
``plot_gradients_components.py`` main, ``:144-179``).

Example::

    python -m robustbnns_tpu_torch.cli.gradients_components --model_idx=7 --n_inputs=16 \
        --compute_grads=True --device=cpu

Loads ``saved_BNNs["model_<idx>"]`` and takes (``--compute_grads=True``, saved
as ``cli.loss_gradients`` saves them) or reads the expected loss gradients
of the first ``--n_inputs`` test images: at 1, 10, 50 and 100 draws for the
stripplot, then at 1, 10 and 100, read from disk, for the heatmaps.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, boolean, load_data, setup_device, timed
from robustbnns_tpu_torch.config import PLOTS, resolve_rel_path, saved_BNNs

STRIP_SAMPLES = [1, 10, 50, 100]  # reference :168
HEATMAP_SAMPLES = [1, 10, 100]  # reference :175


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, n_inputs_default=1000)
    parser.add_argument("--compute_grads", default=False, type=boolean)
    parser.add_argument("--stripplot", default=True, type=boolean)
    parser.add_argument("--heatmaps", default=True, type=boolean)
    return parser


def _get_gradients(compute, bnn, x_test, y_test, n_samples_list, rel_path) -> list:
    from robustbnns_tpu_torch.analysis import load_loss_gradients, loss_gradients

    return [
        loss_gradients(bnn, x_test, y_test, n_samples=s, filename=bnn.name, savedir=bnn.name, rel_path=rel_path)
        if compute else load_loss_gradients(s, bnn.name, bnn.name, rel_path)
        for s in n_samples_list
    ]


def run(args) -> dict:
    """The gradients of both figures; ``args`` is a parsed namespace or a list
    of flags. Returns ``strip`` and ``heatmaps`` (lists of numpy arrays, one
    per sample count), the BNN, the test images and each stage's seconds."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.models.bnn import BNN

    cfg = saved_BNNs[f"model_{args.model_idx}"]
    rel_path = resolve_rel_path(args.savedir)
    _, _, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs, shuffle=False)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device).load(rel_path=rel_path)
    result = {"bnn": bnn, "x_test": x_test, "dataset": cfg.dataset}
    if args.stripplot:
        result["strip"], result["strip_seconds"] = timed(device, lambda: _get_gradients(
            args.compute_grads, bnn, x_test, y_test, STRIP_SAMPLES, rel_path))
    if args.heatmaps:  # reference :176 reads what the stripplot computed
        result["heatmaps"], result["heatmaps_seconds"] = timed(device, lambda: _get_gradients(
            False, bnn, x_test, y_test, HEATMAP_SAMPLES, rel_path))
    return result


def main(args) -> dict:
    """:func:`run`, then the stripplot and the heatmap rows."""
    from robustbnns_tpu_torch.experiments.gradients_figures import (
        stripplot_gradients_components,
        vanishing_gradients_heatmaps,
    )

    result = run(args)
    name = result["bnn"].name
    if "strip" in result:
        result["strip_plot"] = stripplot_gradients_components(result["strip"], STRIP_SAMPLES, result["dataset"],
                                                              name, plots_dir=PLOTS)
    if "heatmaps" in result:
        result["heatmap_plots"] = vanishing_gradients_heatmaps(result["x_test"], result["heatmaps"],
                                                               HEATMAP_SAMPLES, name, plots_dir=PLOTS)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
