"""Overparametrization figure (port of ``robustbnns_tpu/experiments/overparam.py``;
reference ``plot_halfMoons_overparam.py``).

Joins the grid-search checkpoints with their saved expected gradients into
long rows, one per test point (``:34-79``), and scatterplots the gradient
components (∂L/∂x₁, ∂L/∂x₂) per hidden size, coloured by training-set size,
for the cells above a test accuracy of 70 (``:10,82``): the "gradients shrink
to zero in the overparametrized limit" figure.
"""
from __future__ import annotations

import os

import numpy as np

from robustbnns_tpu_torch.config import PLOTS, TESTS
from robustbnns_tpu_torch.experiments.tables import read_rows, write_rows

ACC_THS = 70  # reference :10


def overparam_csv_path(test_points: int, out_dir: str = TESTS) -> str:
    return os.path.join(out_dir, f"halfMoons_lossGrads_final_{test_points}.csv")


def build_overparam_scatterplot_dataset(
    cells,
    posterior_samples_list,
    test_points: int,
    rel_path: str = TESTS,
    out_dir: str = TESTS,
    verbose: bool = True,
    device="cuda",
) -> list[dict]:
    """Evaluate each grid cell and join its saved gradients (reference
    ``:34-79``): 15 columns, one row per (cell, posterior samples, point),
    written to ``halfMoons_lossGrads_final_<test_points>.csv``. The points
    are the unshuffled test set, as in the reference, while the gradients
    were taken on the shuffled one (``grid_compute_grads``)."""
    from robustbnns_tpu_torch.analysis import load_loss_gradients
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.experiments.grid_search import moons_config
    from robustbnns_tpu_torch.models.bnn import BNN

    _, _, x_test, y_test, inp_shape, out_size = load_dataset("half_moons", n_inputs=test_points)
    pts = np.asarray(x_test).squeeze()
    rows = []
    for cell in cells:
        *cfg_args, n_inputs = cell
        cfg = moons_config(*cfg_args)
        bnn = BNN.from_config(cfg, inp_shape, out_size, n_inputs=n_inputs, device=device).load(rel_path=rel_path)
        for n_samples in posterior_samples_list:
            test_acc = bnn.evaluate(x_test, y_test, n_samples=n_samples, batch_size=64, verbose=verbose)
            grads = load_loss_gradients(n_samples, bnn.name, bnn.name, rel_path)
            for idx, grad in enumerate(np.asarray(grads)[:test_points]):
                rows.append({
                    "hidden_size": cfg.hidden_size,
                    "activation": cfg.activation,
                    "architecture": cfg.architecture,
                    "inference": cfg.inference,
                    "epochs": cfg.epochs,
                    "lr": cfg.lr,
                    "n_samples": cfg.n_samples,
                    "warmup": cfg.warmup,
                    "n_inputs": n_inputs,
                    "posterior_samples": n_samples,
                    "test_acc": test_acc,
                    "x": float(pts[idx, 0]),
                    "y": float(pts[idx, 1]),
                    "loss_gradients_x": float(np.ravel(grad)[0]),
                    "loss_gradients_y": float(np.ravel(grad)[1]),
                })
    write_rows(overparam_csv_path(test_points, out_dir), rows)
    return rows


def load_overparam_scatterplot_dataset(test_points: int, out_dir: str = TESTS) -> list[dict]:
    return read_rows(overparam_csv_path(test_points, out_dir))


def plot_half_moons(n_points: int = 200, plots_dir: str = PLOTS) -> str:
    """Scatter of the raw Half Moons data (reference ``:17-31``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    from robustbnns_tpu_torch.data.datasets import load_dataset, onehot_to_labels

    x_train, y_train, *_ = load_dataset("half_moons", n_inputs=n_points)
    sns.set_style("darkgrid")
    fig, ax = plt.subplots(figsize=(10, 6), dpi=150)
    pts = x_train.squeeze()
    df = pd.DataFrame({"x": pts[:, 0], "y": pts[:, 1], "label": onehot_to_labels(y_train)})
    sns.scatterplot(data=df, x="x", y="y", hue="label", alpha=0.9, ax=ax)
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, f"halfMoons_{n_points}.png")
    plt.savefig(path)
    plt.close(fig)
    return path


def overparam_scatterplot(rows, hidden_size, test_points: int, orient: str = "h", plots_dir: str = PLOTS) -> str:
    """Per-hidden-size gradient-component scatter (reference ``:81-144``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    dataset = pd.DataFrame(rows)
    dataset = dataset[dataset["test_acc"] > ACC_THS]
    dataset = dataset[dataset["hidden_size"].isin(hidden_size)]

    rows_vals = np.unique(dataset["hidden_size"])
    nrows = len(rows_vals)
    sns.set_style("darkgrid")
    cmap = plt.get_cmap("rocket_r", 5)
    palette = [matplotlib.colors.rgb2hex(cmap(i + 1)) for i in range(len(np.unique(dataset["n_inputs"])))]

    if orient == "v":
        num_rows, num_cols, figsize = nrows, 1, (4, 7)
    else:
        num_rows, num_cols, figsize = 1, nrows, (10, 2.3)
    fig, ax = plt.subplots(nrows=num_rows, ncols=num_cols, figsize=figsize, dpi=150, facecolor="w", edgecolor="k")
    ax = np.atleast_1d(ax)

    for r, row_val in enumerate(rows_vals):
        df = dataset[dataset["hidden_size"] == row_val]
        legend = "full" if r == nrows - 1 else False
        sns.scatterplot(data=df, x="loss_gradients_x", y="loss_gradients_y", alpha=0.7, hue="n_inputs",
                        size="n_inputs", legend=legend, ax=ax[r], sizes=(30, 80), palette=palette)
        xlim = 1.1 * max(np.max(np.abs(df["loss_gradients_x"])), 1e-12)
        ylim = 1.1 * max(np.max(np.abs(df["loss_gradients_y"])), 1e-12)
        ax[r].set_xlim(-xlim, xlim)
        ax[r].set_ylim(-ylim, ylim)
        ax[r].set_title(str(row_val), fontdict=dict(weight="bold", size=10))
        ax[r].set_xlabel(r"$\langle \frac{\partial L}{\partial x_1}(x,w)\rangle_{p(w|D)}$", labelpad=3, fontsize=11)
    ax[0].set_ylabel(r"$\langle \frac{\partial L}{\partial x_2}(x,w)\rangle_{p(w|D)}$", labelpad=3, fontsize=11)

    plt.tight_layout()
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, f"halfMoons_final_hmc_{test_points}.png")
    plt.savefig(path)
    plt.close(fig)
    return path
