"""Attack trained models (port of ``robustbnns_tpu/cli/attacks.py``; reference
``adversarialAttacks.py`` main, ``:205-353``).

Example::

    python -m robustbnns_tpu_torch.cli.attacks --model_type=bnn --model_idx=7 \
        --train=False --attack_method=pgd --fused=True --n_inputs=256

``--model_type=bnn``: ``--train=True`` trains the posterior first
(:meth:`.models.bnn.BNN.train`) and saves it. Every BNN of the zoo runs: the
SVI ``fc``/``fc2`` models also through the fused kernels (``--fused=True``),
the ``conv`` models (``model_0``, ``2``, ``4``, ``6``, ``8``) through the
unfused predictive, and the HMC models (``model_1``, ``3``, ``9``) on their
first 10 stacked draws, trained by HMC in batches of 5,000 with
``--train=True`` (``--fused=True`` raises for them, as in the JAX package).

``--model_type=nn``: ``saved_NNs["model_<idx>"]``, trained and saved with
``--train=True`` or loaded, evaluated with ``--test=True``, then attacked;
``--attack=False`` loads the attack saved by an earlier run instead.

``--model_type=ensemble``: the 10-member ensemble of ``saved_NNs["model_<idx>"]``
that ``cli.train_ensemble --ensemble_size=10`` saved, loaded and attacked
through its mean raw logits.

``--bf16=True`` runs the branch inside :func:`.utils.device.bf16_scope`, the
switch that ``ROBUSTBNNS_BF16=1`` also throws (the JAX CLI sets that
variable): every dense and conv product of the run (training with
``--train=True``, evaluation and attack) takes bf16 operands with f32 sums. The fused kernels
(``--fused=True``) do not read it: their bf16 variants follow
``ROBUSTBNNS_KERNEL_PRECISION=default``, as JAX's Pallas kernels do.
"""
from __future__ import annotations

import argparse

from robustbnns_tpu_torch.cli.common import add_common_flags, boolean, load_data, setup_device, timed
from robustbnns_tpu_torch.config import EnsembleConfig, resolve_rel_path, saved_BNNs, saved_NNs
from robustbnns_tpu_torch.utils.device import bf16_scope

EPSILON = 0.3  # reference adversarialAttacks.py:207
ENSEMBLE_SIZE = 10  # reference :327


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
        help="bf16 operands for every dense and conv product of the run, f32 sums and results "
             "(as ROBUSTBNNS_BF16=1 does, for this run only; the fused kernels follow "
             "ROBUSTBNNS_KERNEL_PRECISION only)",
    )
    return parser


def _attack_and_evaluate(model, args, x_test, y_test, filename, rel_path, result, n_samples=None, load=False,
                         **kwargs):
    """Attack the first ``--n_inputs`` test images (timed), or with ``load``
    read the attack an earlier run saved, and score the clean and adversarial
    sets; ``result`` gains the sets and the scores."""
    from robustbnns_tpu_torch.attacks import attack, attack_evaluation, load_attack

    x_test, y_test = x_test[: args.n_inputs], y_test[: args.n_inputs]
    if load:
        result["x_attack"] = load_attack(method=args.attack_method, filename=filename, rel_path=rel_path,
                                         device=model.device)
    else:
        result["x_attack"], result["attack_seconds"] = timed(model.device, lambda: attack(
            model, x_test, y_test, method=args.attack_method, epsilon=EPSILON, n_samples=n_samples,
            filename=filename, rel_path=rel_path, **kwargs))
    clean, adv, rob = attack_evaluation(model, x_test, result["x_attack"], y_test, n_samples=n_samples)
    result.update(x_test=x_test, y_test=y_test, clean_accuracy=clean, adversarial_accuracy=adv,
                  softmax_robustness=rob)
    return result


def _build_nn(cfg, inp_shape, out_size, rel_path, args, device, x_train, y_train, x_test, y_test, result):
    """Train and save, or load, the NN; evaluate it with ``--test`` (JAX ``:30-57``)."""
    from robustbnns_tpu_torch.models import DeterministicNN, build_architecture, evaluate_nn, train_nn

    arch = build_architecture(cfg.architecture, cfg.activation, inp_shape, out_size, cfg.hidden_size, cfg.dataset)
    if args.train:
        model, result["train_seconds"] = timed(device, lambda: train_nn(
            arch, x_train, y_train, epochs=cfg.epochs, lr=cfg.lr, name=cfg.name, device=device))
        result["train_images"] = len(x_train)
        model.save(rel_path)
    else:
        model = DeterministicNN(arch=arch, params=None, name=cfg.name, device=device).load(rel_path)
    if args.test:
        result["test_accuracy"] = evaluate_nn(model, x_test, y_test)
    return model


def _nn_branch(args, device, rel_path) -> dict:
    """JAX ``:76-95``: ``--attack=False`` loads the saved attack."""
    cfg = saved_NNs[f"model_{args.model_idx}"]
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, None, shuffle=False)
    result = {}
    result["model"] = nn = _build_nn(cfg, inp_shape, out_size, rel_path, args, device, x_train, y_train,
                                     x_test, y_test, result)
    return _attack_and_evaluate(nn, args, x_test, y_test, cfg.name, rel_path, result, load=not args.attack)


def _bnn_branch(args, device, rel_path) -> dict:
    """The BNN branch attacks whatever ``--attack`` says, as the JAX
    package's does (``:97-123``)."""
    from robustbnns_tpu_torch.models.bnn import BNN

    samples = 10  # the attack's and the defence's draws (reference :251-252)
    cfg = saved_BNNs[f"model_{args.model_idx}"]
    x_train, y_train, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, None, shuffle=False)
    bnn = BNN.from_config(cfg, inp_shape, out_size, device=device)
    result = {"bnn": bnn, "model": bnn}
    if args.train:
        _, result["train_seconds"] = timed(device, lambda: bnn.train(x_train, y_train))
        result["train_images"] = len(x_train)
        bnn.save(rel_path=rel_path)
    else:
        bnn.load(rel_path=rel_path)
    if args.test:
        result["test_accuracy"] = bnn.evaluate(x_test, y_test, n_samples=10)
    return _attack_and_evaluate(bnn, args, x_test, y_test, bnn.name, rel_path, result, n_samples=samples,
                                fused=args.fused)


def _ensemble_branch(args, device, rel_path) -> dict:
    """JAX ``:125-150``: the saved 10-member ensemble, loaded and attacked."""
    from robustbnns_tpu_torch.models import EnsembleNN, build_architecture

    cfg = EnsembleConfig.from_nn(saved_NNs[f"model_{args.model_idx}"], ENSEMBLE_SIZE)
    _, _, x_test, y_test, inp_shape, out_size = load_data(cfg.dataset, args.n_inputs, shuffle=False)
    arch = build_architecture(cfg.architecture, cfg.activation, inp_shape, out_size, cfg.hidden_size, cfg.dataset)
    ens = EnsembleNN(arch=arch, stacked_params=None, ensemble_size=ENSEMBLE_SIZE, name=cfg.name,
                     device=device).load(rel_path)
    return _attack_and_evaluate(ens, args, x_test, y_test, cfg.name, rel_path, {"model": ens})


def main(args) -> dict:
    """Run the attack flow; ``args`` is a parsed namespace or a list of flags.

    Returns the model (``model``; also ``bnn`` for the BNN branch), the clean
    and adversarial sets and scores, and the training and attack wall times
    (synchronised with the card), for callers that check them.
    """
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    branches = {"nn": _nn_branch, "bnn": _bnn_branch, "ensemble": _ensemble_branch}
    if args.model_type not in branches:
        raise NotImplementedError(args.model_type)
    device = setup_device(args.device, args.mesh)
    # JAX cli/attacks.py:61-68 sets ROBUSTBNNS_BF16 for the rest of the
    # process; here the switch holds for this run only.
    with bf16_scope(args.bf16):
        return branches[args.model_type](args, device, resolve_rel_path(args.savedir))


if __name__ == "__main__":
    main(build_parser().parse_args())
