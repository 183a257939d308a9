"""Train/evaluate an NN ensemble (port of ``robustbnns_tpu/cli/train_ensemble.py``;
reference ``model_ensemble.py`` main, ``:109-146``).

Example::

    python -m robustbnns_tpu_torch.cli.train_ensemble --model_idx=0 --ensemble_size=10 \
        --n_inputs=1000 --savedir=TESTS --device=cpu

The members of ``saved_NNs["model_<idx>"]`` train at once as a stacked axis
(the reference trains them one after another), at batch 100, in chunks of
``--member_chunk`` members if given.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, load_data, setup_device
from robustbnns_tpu_torch.config import EnsembleConfig, resolve_rel_path, saved_NNs


def build_parser() -> argparse.ArgumentParser:
    parser = add_common_flags(argparse.ArgumentParser())
    parser.add_argument("--ensemble_size", default=100, type=int, help="size of the ensemble")
    parser.add_argument("--member_chunk", default=None, type=int,
                        help="train members in chunks of this size (memory escape hatch)")
    return parser


def main(args) -> dict:
    """Train (or load) and evaluate; ``args`` is a parsed namespace or a list
    of flags. Returns the model and the test accuracy (``None`` without
    ``--test``)."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.models import EnsembleNN, build_architecture, train_ensemble

    cfg = EnsembleConfig.from_nn(saved_NNs[f"model_{args.model_idx}"], args.ensemble_size)
    rel_path = resolve_rel_path(args.savedir)
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs)
    arch = build_architecture(cfg.architecture, cfg.activation, inp_shape, out_size, cfg.hidden_size, cfg.dataset)

    if args.train:
        model = train_ensemble(arch, x_train, y_train, ensemble_size=cfg.ensemble_size, epochs=cfg.epochs,
                               lr=cfg.lr, batch_size=cfg.batch_size, name=cfg.name,
                               member_chunk=args.member_chunk, device=device)
        model.save(rel_path)
    else:
        model = EnsembleNN(arch=arch, stacked_params=None, ensemble_size=cfg.ensemble_size, name=cfg.name,
                           device=device).load(rel_path)
    accuracy = model.evaluate(x_test, y_test, n_samples=args.ensemble_size, batch_size=64) if args.test else None
    return {"model": model, "test_accuracy": accuracy}


if __name__ == "__main__":
    main(build_parser().parse_args())
