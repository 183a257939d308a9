"""Train/evaluate a deterministic NN (port of ``robustbnns_tpu/cli/train_nn.py``;
reference ``model_nn.py`` main, ``:241-277``).

Example::

    python -m robustbnns_tpu_torch.cli.train_nn --n_inputs=10 --model_idx=0 \
        --train=True --test=True --savedir=TESTS --device=cpu

Trains ``saved_NNs["model_<idx>"]`` at batch 64 for its configured epochs and
learning rate and saves it (``--train=True``), or loads it; then evaluates it
on the test set (``--test=True``).
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, load_data, setup_device
from robustbnns_tpu_torch.config import resolve_rel_path, saved_NNs


def build_parser() -> argparse.ArgumentParser:
    return add_common_flags(argparse.ArgumentParser(description="Base NN"))


def main(args) -> dict:
    """Train (or load) and evaluate; ``args`` is a parsed namespace or a list
    of flags. Returns the model and the test accuracy (``None`` without
    ``--test``)."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.models import DeterministicNN, build_architecture, evaluate_nn, train_nn

    cfg = saved_NNs[f"model_{args.model_idx}"]
    rel_path = resolve_rel_path(args.savedir)
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs)
    arch = build_architecture(cfg.architecture, cfg.activation, inp_shape, out_size, cfg.hidden_size, cfg.dataset)

    if args.train:
        print("\n == NN training ==")
        model = train_nn(arch, x_train, y_train, epochs=cfg.epochs, lr=cfg.lr, batch_size=64, name=cfg.name,
                         device=device)
        model.save(rel_path)
    else:
        model = DeterministicNN(arch=arch, params=None, name=cfg.name, device=device).load(rel_path)
    accuracy = evaluate_nn(model, x_test, y_test) if args.test else None
    return {"model": model, "test_accuracy": accuracy}


if __name__ == "__main__":
    main(build_parser().parse_args())
