"""Train/evaluate a BNN (port of ``robustbnns_tpu/cli/train_bnn.py``,
reference ``model_bnn.py`` main, ``:393-426``).

Example::

    python -m robustbnns_tpu_torch.cli.train_bnn --model_idx=3 --n_inputs=1000 \
        --train=True --test=True --savedir=TESTS --device=cpu

SVI models train by SVI and ignore the HMC flags; HMC models (``model_1``,
``3``, ``9``) train by HMC in batches of 5,000 (``--hmc_mode``, ``--hmc_init``,
``--num_chains``), or by NUTS with ``--hmc_sampler=nuts``. ``run`` trains,
saves and evaluates; ``main`` adds an SVI training's curve (matplotlib).
Across cards: ``torchrun --nproc_per_node=8 -m robustbnns_tpu_torch.cli.train_bnn
--mesh=8 ...``.
"""
from __future__ import annotations

import argparse
import os

from robustbnns_tpu_torch.cli.common import add_common_flags, load_data, setup_device
from robustbnns_tpu_torch.config import bnn_batch_size, resolve_rel_path, saved_BNNs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--hmc_mode", default="faithful", type=str,
                        help="faithful (per-batch mcmc.run), full (one chain)")
    parser.add_argument("--hmc_init", default="random", type=str,
                        help="random (reference), map (Adam warm start)")
    parser.add_argument("--hmc_sampler", default="hmc", type=str, help="hmc (reference kernel), nuts")
    parser.add_argument("--num_chains", default=1, type=int)
    return parser


def run(args):
    """Train and save (or load), then evaluate; ``args`` is a parsed namespace
    or a list of flags. Returns the BNN, its ``history`` holding the training
    curve. Draws no figure, so it runs where matplotlib is absent."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.models.bnn import BNN

    cfg = saved_BNNs[f"model_{args.model_idx}"]
    rel_path = resolve_rel_path(args.savedir)
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device)

    if args.train:
        bnn.train(
            x_train, y_train, batch_size=bnn_batch_size(cfg), hmc_mode=args.hmc_mode,
            hmc_init=args.hmc_init, hmc_sampler=args.hmc_sampler, num_chains=args.num_chains,
        )
        bnn.save(rel_path=rel_path)
    else:
        bnn.load(rel_path=rel_path)

    if args.test:
        test_samples = 10
        print("\n== Evaluate on test data ==\n")
        bnn.evaluate(x_test, y_test, n_samples=test_samples)

        print(f"\n== Evaluate the first {test_samples} posterior samples ==\n")
        for seed in range(test_samples):
            bnn.evaluate(x_test, y_test, n_samples=1, seeds=[seed])
    return bnn


def main(args):
    """:func:`run`, then an SVI training's loss and accuracy curve."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    bnn = run(args)
    if args.train and not bnn.is_hmc:
        from robustbnns_tpu_torch.parallel.mesh import write_on_rank_zero
        from robustbnns_tpu_torch.utils.plotting import plot_loss_accuracy

        rel_path = resolve_rel_path(args.savedir)
        write_on_rank_zero(lambda: plot_loss_accuracy(
            bnn.history, os.path.join(rel_path, bnn.name, bnn.name + "_training.png")))
    return bnn


if __name__ == "__main__":
    main(build_parser().parse_args())
