"""Baseline comparison (port of ``robustbnns_tpu/experiments/baseline.py``;
reference ``plot_baseline_attacks.py``).

Attacks the deterministic, Bayesian and ensemble versions of one
architecture and collects long rows of per-image robustness (``:10-130``),
saved as ``<dataset>_baseline_attacks_<method>.csv`` (``:132-139``) and
plotted as adversarial accuracy and softmax robustness against defence
samples (``:148-181``).
"""
from __future__ import annotations

import os

import torch

from robustbnns_tpu_torch.config import PLOTS, TESTS
from robustbnns_tpu_torch.experiments.tables import read_rows, write_rows


def _rows(model_type, method, epsilon, test_acc, adv_acc, rob, attack_s, defence_s):
    return [
        {
            "model_type": model_type,
            "attack_method": method,
            "epsilon": epsilon,
            "test_acc": test_acc,
            "adv_acc": adv_acc,
            "softmax_rob": r,
            "attack_samples": attack_s,
            "defence_samples": defence_s,
        }
        for r in torch.as_tensor(rob).tolist()
    ]


def build_baseline_attacks_df(
    nn,
    bnn,
    ensemble,
    x_test,
    y_test,
    *,
    attack_method: str = "fgsm",
    epsilon: float = 0.3,
    bayesian_attack_samples=(1,),
    bayesian_defence_samples=(1, 50, 100),
    ensemble_samples=(1, 50, 100),
    rel_path: str = TESTS,
    verbose: bool = True,
) -> list[dict]:
    """Attack the NN, the BNN and the ensemble; one row per image: the NN's,
    then the BNN's for each attack × defence sample count, then the
    ensemble's for each member count (reference ``:10-130``; sweeps
    ``:65-66,90``)."""
    from robustbnns_tpu_torch.attacks import attack, attack_evaluation

    rows = []
    nn_name = getattr(nn, "name", None)
    nn_attack = attack(nn, x_test, y_test, method=attack_method, epsilon=epsilon, filename=nn_name,
                       rel_path=rel_path, save=nn_name is not None, verbose=verbose)
    test_acc, adv_acc, rob = attack_evaluation(nn, x_test, nn_attack, y_test, verbose=verbose)
    rows += _rows("nn", attack_method, epsilon, test_acc, adv_acc, rob, 1, None)

    for attack_samples in bayesian_attack_samples:
        bnn_attack = attack(bnn, x_test, y_test, method=attack_method, epsilon=epsilon, n_samples=attack_samples,
                            filename=bnn.name, rel_path=rel_path, verbose=verbose)
        for defence_samples in bayesian_defence_samples:
            test_acc, adv_acc, rob = attack_evaluation(bnn, x_test, bnn_attack, y_test, n_samples=defence_samples,
                                                       verbose=verbose)
            rows += _rows("bnn", attack_method, epsilon, test_acc, adv_acc, rob, attack_samples, defence_samples)

    for n_samples in ensemble_samples:
        ens_attack = attack(ensemble, x_test, y_test, method=attack_method, epsilon=epsilon, n_samples=n_samples,
                            filename=ensemble.name, rel_path=rel_path, save=ensemble.name is not None,
                            verbose=verbose)
        test_acc, adv_acc, rob = attack_evaluation(ensemble, x_test, ens_attack, y_test, n_samples=n_samples,
                                                   verbose=verbose)
        rows += _rows("ensemble", attack_method, epsilon, test_acc, adv_acc, rob, n_samples, n_samples)
    return rows


def _csv_path(dataset_name, attack_method, out_dir) -> str:
    return os.path.join(out_dir, f"{dataset_name}_baseline_attacks_{attack_method}.csv")


def save_baseline_attacks_df(rows: list[dict], dataset_name: str, attack_method: str, out_dir: str = TESTS) -> str:
    return write_rows(_csv_path(dataset_name, attack_method, out_dir), rows)


def load_baseline_attacks_df(dataset_name, attack_method, out_dir=TESTS) -> list[dict]:
    return read_rows(_csv_path(dataset_name, attack_method, out_dir))


def lineplot_baseline_attacks(rows, dataset_name: str, attack_method: str, n_inputs: int,
                              plots_dir: str = PLOTS) -> str:
    """Two-panel lineplot against defence samples (reference ``:148-181``);
    each row is repeated at both ends of the x-range, so the NN and the
    ensemble show as lines (``:163-167``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.DataFrame(rows)
    sns.set_style("darkgrid")
    fig, ax = plt.subplots(nrows=1, ncols=2, figsize=(10, 6), dpi=150, facecolor="w", edgecolor="k")
    plt.suptitle(f"{attack_method} attack on {dataset_name}")
    extended = [df]
    for xv in (df["defence_samples"].min(), df["defence_samples"].max()):
        d = df.copy()
        d["defence_samples"] = xv
        extended.append(d)
    dfx = pd.concat(extended, ignore_index=True)
    palette = ["black", "darkred", "darkorange"]
    sns.lineplot(data=dfx, x="defence_samples", y="adv_acc", hue="model_type", ax=ax[0], palette=palette)
    sns.lineplot(data=dfx, x="defence_samples", y="softmax_rob", hue="model_type", ax=ax[1], palette=palette)
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, f"{dataset_name}_baseline_attacks_{attack_method}_{n_inputs}.png")
    plt.savefig(path)
    plt.close(fig)
    return path
