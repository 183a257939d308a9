"""BNN ε-sweep attacks (port of ``robustbnns_tpu/cli/eps_attacks.py``; reference
``plot_eps_attacks.py`` main, ``:68-101``).

Example::

    python -m robustbnns_tpu_torch.cli.eps_attacks --model_idx=7 --n_inputs=16 --device=cpu

Loads ``saved_BNNs["model_<idx>"]`` from ``--savedir``, evaluates it on the
first ``--n_inputs`` test images (``--test``) and attacks them at ε ∈ {0.1,
0.15, 0.2, 0.25, 0.3} with 1, 10 and 50 draws, writing
``<dataset>_increasing_eps_<method>.csv`` in the model's directory;
``--attack=False`` reads that file instead.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, boolean, load_data, setup_device, timed
from robustbnns_tpu_torch.config import resolve_rel_path, saved_BNNs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, n_inputs_default=100)
    parser.add_argument("--attack", default=True, type=boolean)
    parser.add_argument("--attack_method", default="fgsm", type=str)
    return parser


def run(args) -> dict:
    """Sweep or read; ``args`` is a parsed namespace or a list of flags.
    Returns the rows, the BNN, the test accuracy and the sweep's seconds."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.experiments.eps import build_eps_attacks_df, load_eps_attacks_df
    from robustbnns_tpu_torch.models.bnn import BNN

    cfg = saved_BNNs[f"model_{args.model_idx}"]
    rel_path = resolve_rel_path(args.savedir)
    _, _, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs, shuffle=False)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device).load(rel_path=rel_path)
    result = {"bnn": bnn, "x_test": x_test[: args.n_inputs], "y_test": y_test[: args.n_inputs]}
    if args.test:
        result["test_accuracy"] = bnn.evaluate(x_test, y_test, n_samples=10)
    if args.attack:
        result["rows"], result["attack_seconds"] = timed(device, lambda: build_eps_attacks_df(
            bnn, result["x_test"], result["y_test"], dataset=cfg.dataset, method=args.attack_method,
            out_dir=rel_path))
    else:
        result["rows"] = load_eps_attacks_df(cfg.dataset, args.attack_method, bnn.name, rel_path)
    return result


def main(args) -> dict:
    """:func:`run`, then the two lineplots."""
    from robustbnns_tpu_torch.experiments.eps import lineplot_increasing_eps

    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    result = run(args)
    dataset = saved_BNNs[f"model_{args.model_idx}"].dataset
    result["plot"] = lineplot_increasing_eps(result["rows"], dataset, args.attack_method)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
