"""NN against BNN against ensemble (port of ``robustbnns_tpu/cli/baseline_attacks.py``;
reference ``plot_baseline_attacks.py`` main, ``:184-199``).

Example::

    python -m robustbnns_tpu_torch.cli.baseline_attacks --model_idx=7 --device=cpu --n_inputs=64

Needs, under ``--savedir``, the NN ``saved_NNs["model_<idx>"]`` (``cli.train_nn``),
the BNN ``saved_BNNs["model_<idx>"]`` (``cli.train_bnn``) and the
``--ensemble_size``-member ensemble of the NN's architecture
(``cli.train_ensemble``). Attacks the first ``--n_inputs`` test images and
writes ``<dataset>_baseline_attacks_<method>.csv`` under the TESTS directory;
``--attack=False`` reads that file instead.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, boolean, load_data, setup_device, timed
from robustbnns_tpu_torch.config import EnsembleConfig, resolve_rel_path, saved_BNNs, saved_NNs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, n_inputs_default=1000)
    parser.add_argument("--attack", default=True, type=boolean)
    parser.add_argument("--attack_method", default="fgsm", type=str)
    parser.add_argument("--ensemble_size", default=100, type=int)
    return parser


def run(args) -> dict:
    """Attack the three models, or read their rows; ``args`` is a parsed
    namespace or a list of flags. Returns the rows, the CSV's path, the
    models, the test images and the attack's seconds."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.experiments.baseline import (
        build_baseline_attacks_df,
        load_baseline_attacks_df,
        save_baseline_attacks_df,
    )
    from robustbnns_tpu_torch.models import BNN, DeterministicNN, EnsembleNN, build_architecture

    rel_path = resolve_rel_path(args.savedir)
    nn_cfg = saved_NNs[f"model_{args.model_idx}"]
    bnn_cfg = saved_BNNs[f"model_{args.model_idx}"]
    _, _, x_test, y_test, inp_shape, out_size = load_data(nn_cfg.dataset, args.n_inputs, shuffle=False)
    x_test, y_test = x_test[: args.n_inputs], y_test[: args.n_inputs]
    result = {"x_test": x_test, "y_test": y_test}
    if not args.attack:
        result["rows"] = load_baseline_attacks_df(nn_cfg.dataset, args.attack_method)
        return result

    arch = build_architecture(nn_cfg.architecture, nn_cfg.activation, inp_shape, out_size, nn_cfg.hidden_size,
                              nn_cfg.dataset)
    nn = DeterministicNN(arch=arch, params=None, name=nn_cfg.name, device=device).load(rel_path)
    bnn = BNN.from_config(bnn_cfg, inp_shape, out_size, device=device).load(rel_path=rel_path)
    ens_cfg = EnsembleConfig.from_nn(nn_cfg, args.ensemble_size)
    ensemble = EnsembleNN(arch=arch, stacked_params=None, ensemble_size=args.ensemble_size, name=ens_cfg.name,
                          device=device).load(rel_path)
    ens_samples = tuple(s for s in (1, 50, 100) if s <= args.ensemble_size) or (args.ensemble_size,)
    result["rows"], result["attack_seconds"] = timed(device, lambda: build_baseline_attacks_df(
        nn, bnn, ensemble, x_test, y_test, attack_method=args.attack_method, bayesian_defence_samples=(1, 50, 100),
        ensemble_samples=ens_samples, rel_path=rel_path))
    result["csv"] = save_baseline_attacks_df(result["rows"], nn_cfg.dataset, args.attack_method)
    result.update(nn=nn, bnn=bnn, ensemble=ensemble)
    return result


def main(args) -> dict:
    """:func:`run`, then the lineplot."""
    from robustbnns_tpu_torch.experiments.baseline import lineplot_baseline_attacks

    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    result = run(args)
    result["plot"] = lineplot_baseline_attacks(result["rows"], saved_NNs[f"model_{args.model_idx}"].dataset,
                                               args.attack_method, args.n_inputs)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
