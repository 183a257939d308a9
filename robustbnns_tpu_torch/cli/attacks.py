"""Attack trained models (port of ``robustbnns_tpu/cli/attacks.py``, BNN branch).

Example::

    python -m robustbnns_tpu_torch.cli.attacks --model_type=bnn --model_idx=7 \
        --train=False --attack_method=pgd --fused=True --n_inputs=256

``--train=True`` trains the posterior first (:meth:`.models.bnn.BNN.train`)
and saves it. Every BNN of the zoo runs: the SVI ``fc``/``fc2`` models also
through the fused kernels (``--fused=True``), the ``conv`` models (``model_0``,
``2``, ``4``, ``6``, ``8``) through the unfused predictive, and the HMC models
(``model_1``, ``3``, ``9``) on their first 10 stacked draws, trained by HMC in
batches of 5,000 with ``--train=True`` (``--fused=True`` raises for them, as
in the JAX package). The NN and ensemble branches wait for their slice.
"""
from __future__ import annotations

import argparse
import time

import torch

from robustbnns_tpu_torch.cli.common import add_common_flags, boolean, load_data, setup_device
from robustbnns_tpu_torch.config import resolve_rel_path, saved_BNNs

EPSILON = 0.3  # reference adversarialAttacks.py:207


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, n_inputs_default=1000)
    parser.add_argument("--model_type", default="nn", type=str, help="nn, bnn, ensemble")
    parser.add_argument("--attack", default=True, type=boolean)
    parser.add_argument("--attack_method", default="fgsm", type=str, help="fgsm, pgd")
    parser.add_argument(
        "--fused", default=False, type=boolean,
        help="route BNN attack forwards through the CUDA sampled-dense kernels "
             "(SVI + fc/fc2 only)",
    )
    parser.add_argument(
        "--bf16", default=False, type=boolean,
        help="bf16 matmuls for all forwards (not ported: the port is exact f32)",
    )
    return parser


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args) -> dict:
    """Run the attack flow; ``args`` is a parsed namespace or a list of flags.

    Returns the model, the clean and adversarial sets and scores, and the
    training and attack wall times (synchronised with the card), for callers
    that check them.
    """
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    if args.bf16:
        raise NotImplementedError("--bf16 is not ported: the port keeps exact f32")
    device = setup_device(args.device, args.mesh)

    from robustbnns_tpu_torch.attacks import attack, attack_evaluation
    from robustbnns_tpu_torch.models.bnn import BNN

    rel_path = resolve_rel_path(args.savedir)
    if args.model_type != "bnn":
        raise NotImplementedError(
            f"--model_type={args.model_type} is not ported yet (NN/ensemble slice, ROADMAP.md)"
        )
    # The BNN branch attacks whatever --attack says, as the JAX package's
    # does; only the NN branch loads a saved attack for --attack=False.
    bayesian_attack_samples = [10]  # reference :251
    bayesian_defence_samples = [10]  # reference :252
    cfg = saved_BNNs[f"model_{args.model_idx}"]
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, None, shuffle=False)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device)
    result = {"bnn": bnn}
    if args.train:
        _synchronize(device)
        t0 = time.perf_counter()
        bnn.train(x_train, y_train)
        _synchronize(device)
        result["train_seconds"] = time.perf_counter() - t0
        result["train_images"] = len(x_train)
        bnn.save(rel_path=rel_path)
    else:
        bnn.load(rel_path=rel_path)
    if args.test:
        result["test_accuracy"] = bnn.evaluate(x_test, y_test, n_samples=10)

    x_test, y_test = x_test[: args.n_inputs], y_test[: args.n_inputs]
    for attack_samples in bayesian_attack_samples:
        _synchronize(device)
        t0 = time.perf_counter()
        x_attack = attack(
            bnn, x_test, y_test, method=args.attack_method, epsilon=EPSILON,
            n_samples=attack_samples, fused=args.fused, filename=bnn.name, rel_path=rel_path,
        )
        _synchronize(device)
        result["attack_seconds"] = time.perf_counter() - t0
        for defence_samples in bayesian_defence_samples:
            clean, adv, rob = attack_evaluation(bnn, x_test, x_attack, y_test, n_samples=defence_samples)
    result.update(
        x_test=x_test, y_test=y_test, x_attack=x_attack,
        clean_accuracy=clean, adversarial_accuracy=adv, softmax_robustness=rob,
    )
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
