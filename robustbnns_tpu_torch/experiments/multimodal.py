"""Posterior multimodality (port of ``robustbnns_tpu/experiments/multimodal.py``;
reference ``test_multimodal.py``).

Trains single-chain full-batch HMC BNNs at increasing training-set sizes
(``batch_size = n_inputs``, reference ``:72-74``), flattens every posterior
draw, projects the draws and 1,000 N(0, 1) prior draws to 2-D by PCA (one
PCA per setting, or one shared, ``:100-161``), and KDE-plots the prior
against the posteriors (``:170-194``).

The PCA is the exact top-two principal components (:func:`pca_fit`), where
the JAX package's sklearn ``PCA(n_components=2)`` picks its solver by shape:
the covariance eigendecomposition for tall, narrow data, a full SVD up to
500×500 and otherwise a randomized SVD with no fixed seed, so JAX's output at
MNIST widths repeats only up to sign and rounding.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from robustbnns_tpu_torch.config import DATA, PLOTS, BNNConfig

PRIOR_DRAWS = 1000  # reference :109-118


def flat_posterior(bnn) -> torch.Tensor:
    """The ``(S, D)`` matrix of flattened posterior draws, leaves in JAX's
    ``ravel_pytree`` order (:func:`.utils.pytree.tree_leaves`), on ``bnn.device``."""
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    if bnn.samples is None:
        raise ValueError("train() or load() the HMC BNN first")
    return torch.cat([v.reshape(v.shape[0], -1) for v in tree_leaves(bnn.samples)], dim=1)


def prior_draws(d: int, seed: int = 0) -> np.ndarray:
    """``np.random.default_rng(seed).standard_normal((1000, d))`` as float32, as
    the JAX package draws them, made 64 rows at a time so the host never holds
    the whole float64 matrix (5.4 GB at ``model_10``'s D = 669,706)."""
    rng = np.random.default_rng(seed)
    out = np.empty((PRIOR_DRAWS, d), np.float32)
    for i in range(0, PRIOR_DRAWS, 64):
        out[i : i + 64] = rng.standard_normal((min(64, PRIOR_DRAWS - i), d))
    return out


def pca_fit(x: torch.Tensor, n_components: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean ``(D,)`` and the top principal axes ``(n_components, D)`` of
    the rows of ``x``, in float64 on ``x``'s device.

    The axes are the leading eigenvectors of the centred data's ``n × n``
    Gram matrix mapped back through the data (``n ≤ D``), or of its ``D × D``
    scatter matrix (``n > D``), with sklearn's sign rule (``svd_flip`` with
    ``u_based_decision=False``): each axis's entry of largest magnitude is
    positive.
    """
    x = x.to(torch.float64)
    mean = x.mean(0)
    xc = x - mean
    del x
    if xc.shape[0] <= xc.shape[1]:
        top = torch.linalg.eigh(xc @ xc.T)[1][:, -n_components:].flip(1)
        # Unit axes: an axis of zero variance (draws that repeat) maps to 0.
        axes = (xc.T @ top).T
        axes = axes / axes.norm(dim=1, keepdim=True).clamp_min(torch.finfo(axes.dtype).tiny)
    else:
        axes = torch.linalg.eigh(xc.T @ xc)[1][:, -n_components:].flip(1).T
    signs = torch.sign(axes.gather(1, axes.abs().argmax(1, keepdim=True)))
    return mean, axes * signs


def pca_transform(x: torch.Tensor, mean: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` projected on ``axes`` about ``mean`` (sklearn's
    ``transform``), as float32."""
    return ((x.to(torch.float64) - mean) @ axes.T).float()


def pca_fit_transform(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    return pca_transform(x, *pca_fit(x, n_components))


def multimodal_filename(cfg: BNNConfig, n_inputs: int) -> str:
    """Reference per-setting checkpoint name (``:76``)."""
    return f"{cfg.dataset}_{cfg.architecture}_{cfg.inference}_trainInp={n_inputs}"


def build_multimodal_df(
    cfg: BNNConfig,
    n_inputs_list,
    *,
    n_samples: int,
    rel_path: str = DATA,
    train: bool = True,
    evaluate: bool = True,
    same_pca: bool = False,
    seed: int = 0,
    hmc_sampler: str = "hmc",
    hmc_init: str = "random",
    verbose: bool = True,
    device="cuda",
) -> list[dict]:
    """Train (or load) one posterior per training-set size and project its
    first ``n_samples`` draws and the prior draws to 2-D: 1,000 prior rows
    (``n_training_points`` 0), then ``n_samples`` rows per setting.

    Each posterior is one full-batch chain (reference ``:72-74``), saved
    under ``<rel_path>/<name>/<multimodal_filename>``. ``hmc_sampler='nuts'``
    samples it by NUTS.
    """
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models.bnn import BNN

    x_train_full, y_train_full, x_test, y_test, inp_shape, out_size = load_dataset(
        cfg.dataset, n_inputs=60000, shuffle=True, fallback="synthetic"
    )
    all_weights = {}
    for n_inputs in n_inputs_list:
        filename = multimodal_filename(cfg, n_inputs)
        bnn = BNN.from_config(cfg, inp_shape, out_size, device=device)
        if train:
            if verbose:
                print(f"\n=== multimodal: training {filename}")
            bnn.train(x_train_full[:n_inputs], y_train_full[:n_inputs], batch_size=n_inputs, hmc_mode="full",
                      seed=seed, hmc_sampler=hmc_sampler, hmc_init=hmc_init, verbose=verbose)
            bnn.save(rel_path=rel_path, filename=filename)
        else:
            bnn.load(rel_path=rel_path, filename=filename)
        if evaluate:
            bnn.evaluate(x_test, y_test, n_samples=n_samples, verbose=verbose)
        all_weights[n_inputs] = flat_posterior(bnn)[:n_samples]
        del bnn

    first = all_weights[n_inputs_list[0]]
    prior = torch.from_numpy(prior_draws(first.shape[1], seed)).to(first.device)
    if same_pca:
        fitted = pca_fit(torch.cat(list(all_weights.values())))
        prior_2d = pca_transform(prior, *fitted)
        projected = {n: pca_transform(w, *fitted) for n, w in all_weights.items()}
    else:
        prior_2d = pca_fit_transform(prior)
        projected = {n: pca_fit_transform(w) for n, w in all_weights.items()}
    del prior

    rows = [{"n_samples": PRIOR_DRAWS, "n_training_points": 0, "x": a, "y": b} for a, b in prior_2d.tolist()]
    for n_inputs, w2d in projected.items():
        rows += [{"n_samples": int(n_samples), "n_training_points": n_inputs, "x": a, "y": b}
                 for a, b in w2d.tolist()]
    return rows


def plot_multimodal_kde(rows, n_inputs_list, plot_filename: str, plots_dir: str = PLOTS) -> str:
    """Prior and per-setting posterior KDEs (reference ``:170-194``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.DataFrame(rows)
    cmap = plt.get_cmap("rocket", 5)
    palette = [matplotlib.colors.rgb2hex(cmap(i)) for i in range(cmap.N)]
    sns.set_style("darkgrid")
    fig, ax = plt.subplots(1, len(n_inputs_list) + 1, figsize=(10, 3), dpi=150, facecolor="w", edgecolor="k")
    fig.tight_layout()
    sns.kdeplot(data=df[df["n_training_points"] == 0], x="x", y="y", ax=ax[0], color=palette[0])
    ax[0].set_title("Prior", weight="bold")
    for idx, n_inputs in enumerate(n_inputs_list):
        sns.kdeplot(data=df[df["n_training_points"] == n_inputs], x="x", y="y", ax=ax[idx + 1],
                    color=palette[idx + 1])
        ax[idx + 1].set_title(f"Posterior\nTraining pts = {n_inputs}", weight="bold")
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, plot_filename + ".png")
    fig.savefig(path)
    plt.close(fig)
    return path
