"""ε sweep (port of ``robustbnns_tpu/experiments/eps.py``; reference
``plot_eps_attacks.py``).

Attacks a BNN over increasing ε and sample counts, the same count for the
attack and the defence (``:16-33``); CSV ``<dataset>_increasing_eps_<method>.csv``
and two stacked lineplots (``:45-65``).
"""
from __future__ import annotations

import os

import torch

from robustbnns_tpu_torch.config import DATA, PLOTS
from robustbnns_tpu_torch.experiments.tables import read_rows, write_rows


def _csv_path(dataset, method, savedir, out_dir) -> str:
    return os.path.join(out_dir, savedir, f"{dataset}_increasing_eps_{method}.csv")


def build_eps_attacks_df(
    bnn,
    x_test,
    y_test,
    *,
    dataset: str,
    method: str = "fgsm",
    epsilon_list=(0.1, 0.15, 0.2, 0.25, 0.3),
    n_samples_list=(1, 10, 50),
    savedir: str | None = None,
    out_dir: str = DATA,
    verbose: bool = True,
) -> list[dict]:
    """One row per image for each (ε, n_samples), the attack unsaved
    (reference ``:16-33``; sweep ``:89-90``), written under
    ``<out_dir>/<savedir or bnn.name>/``."""
    from robustbnns_tpu_torch.attacks import attack, attack_evaluation

    rows = []
    for epsilon in epsilon_list:
        for n_samples in n_samples_list:
            x_attack = attack(bnn, x_test, y_test, method=method, epsilon=epsilon, n_samples=n_samples,
                              save=False, verbose=verbose)
            test_acc, adv_acc, rob = attack_evaluation(bnn, x_test, x_attack, y_test, n_samples=n_samples,
                                                       verbose=verbose)
            rows += [
                {"attack_method": method, "epsilon": epsilon, "test_acc": test_acc, "adv_acc": adv_acc,
                 "softmax_rob": r, "n_samples": n_samples}
                for r in torch.as_tensor(rob).tolist()
            ]
    write_rows(_csv_path(dataset, method, savedir or bnn.name, out_dir), rows)
    return rows


def load_eps_attacks_df(dataset, method, savedir, out_dir=DATA) -> list[dict]:
    return read_rows(_csv_path(dataset, method, savedir, out_dir))


def lineplot_increasing_eps(rows, dataset: str, method: str, plots_dir: str = PLOTS) -> str:
    """adv_acc and softmax_rob against ε, styled by n_samples (reference ``:45-65``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.DataFrame(rows)
    sns.set_style("darkgrid")
    palette = ["black", "darkred", "darkorange"]
    fig, ax = plt.subplots(nrows=2, ncols=1, figsize=(8, 6), dpi=150, facecolor="w", edgecolor="k")
    plt.suptitle(f"{method} attack on {dataset}")
    sns.lineplot(data=df, x="epsilon", y="adv_acc", style="n_samples", hue="n_samples", ax=ax[0], palette=palette)
    sns.lineplot(data=df, x="epsilon", y="softmax_rob", style="n_samples", hue="n_samples", ax=ax[1],
                 palette=palette)
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, f"{dataset}_increasing_eps_{method}.png")
    plt.savefig(path)
    plt.close(fig)
    return path
