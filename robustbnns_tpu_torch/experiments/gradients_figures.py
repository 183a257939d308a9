"""Gradient-components figures (port of
``robustbnns_tpu/experiments/gradients_figures.py``; reference
``plot_gradients_components.py``).

* a stripplot of every expected-gradient component, one strip per posterior
  sample count (reference ``:17-52``);
* one heatmap row per image the vanishing-norm detector flags: the image, then
  its expected-gradient heatmap at each sample count, titled with its norm
  (reference ``:54-122``).

The figures' look lives in the style constants below, the JAX package's.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from robustbnns_tpu_torch.analysis import compute_vanishing_norms_idxs
from robustbnns_tpu_torch.config import PLOTS

STRIP_FIGSIZE = (5, 4)
STRIP_DPI = 150
STRIP_STYLE = dict(jitter=0.2, alpha=0.4, palette="rocket", linewidth=-0.1)
STRIP_XLABEL = r"Number of posterior samples $w \sim p(w|D)$"
STRIP_YLABEL = r"Expected gradients $\langle\frac{\partial L}{\partial x_i}(x,w)\rangle_{p(w|D)}$"

HEATMAP_ROW_FIGSIZE = (10, 3)
HEATMAP_IMAGE_CMAP = "Greys_r"
HEATMAP_GRAD_CMAP = "vlag"
# Shared colorbar strip on the right edge + the layout that leaves room for it.
HEATMAP_CBAR_BOX = (0.93, 0.12, 0.01, 0.7)  # (left, bottom, width, height)
HEATMAP_LAYOUT = dict(h_pad=2, w_pad=2, rect=[0, 0, HEATMAP_CBAR_BOX[0], 1])
HEATMAP_TITLE_FONT = dict(fontsize=20, weight="bold")
HEATMAP_LABEL_FONT = dict(fontsize=18, weight="bold")


def _grad_norm(g: np.ndarray, norm: str) -> float:
    if norm == "linfty":
        return float(np.max(np.abs(g)))
    if norm == "l2":
        return float(np.linalg.norm(g, ord=2))
    raise ValueError(f"unknown norm {norm!r}")


def stripplot_gradients_components(
    loss_gradients_list: Sequence[np.ndarray],
    n_samples_list: Sequence[int],
    dataset_name: str,
    filename: str,
    plots_dir: str = PLOTS,
) -> str:
    """All gradient components as strips, one per sample count;
    ``loss_gradients_list[i]`` holds the gradients at ``n_samples_list[i]``
    draws (any shape). Saves ``<filename>_gradComponents.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.concat(
        [pd.DataFrame({"loss_gradients": np.asarray(g).ravel(), "n_samples": n})
         for g, n in zip(loss_gradients_list, n_samples_list)],
        ignore_index=True,
    )
    sns.set_style("darkgrid")
    fig, ax = plt.subplots(figsize=STRIP_FIGSIZE, dpi=STRIP_DPI)
    sns.stripplot(x="n_samples", y="loss_gradients", data=df, ax=ax, **STRIP_STYLE)
    ax.set_xlabel(STRIP_XLABEL)
    ax.set_ylabel(STRIP_YLABEL)
    fig.tight_layout()
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, filename + "_gradComponents.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def _vanishing_gradient_heatmap(plt, sns, image, gradients, n_samples_list, norm):
    """One row: the image, then one heatmap per sample count on one shared
    colour scale with one colorbar, each titled with its norm."""
    fig, axs = plt.subplots(nrows=1, ncols=1 + len(n_samples_list), figsize=HEATMAP_ROW_FIGSIZE)
    sns.heatmap(image, ax=axs[0], square=True, cmap=HEATMAP_IMAGE_CMAP, cbar=False)
    axs[0].set_xlabel("   Samples:", **HEATMAP_LABEL_FONT)
    scale = dict(vmin=float(np.min(gradients)), vmax=float(np.max(gradients)))
    cbar_ax = fig.add_axes(HEATMAP_CBAR_BOX)
    last = len(n_samples_list) - 1
    for i, (g, n_samples) in enumerate(zip(gradients, n_samples_list)):
        ax = axs[1 + i]
        sns.heatmap(g, ax=ax, square=True, cmap=HEATMAP_GRAD_CMAP, cbar=(i == last), cbar_ax=cbar_ax, **scale)
        ax.set_title(f"{_grad_norm(g, norm):.3f}", **HEATMAP_TITLE_FONT)
        ax.set_xlabel(f"{n_samples}", **HEATMAP_LABEL_FONT)
    for ax in axs:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout(**HEATMAP_LAYOUT)
    return fig


def vanishing_gradients_heatmaps(
    test_images: np.ndarray,
    loss_gradients_list: Sequence[np.ndarray],
    n_samples_list: Sequence[int],
    filename: str,
    norm: str = "linfty",
    plots_dir: str = PLOTS,
) -> list[str]:
    """One heatmap row per image the vanishing-norm detector flags;
    ``loss_gradients_list`` is indexed ``[sample_count][image]``."""
    per_image = np.swapaxes(np.asarray(loss_gradients_list), 0, 1)
    if per_image.shape[1] != len(n_samples_list):
        raise ValueError(f"expected gradients for {len(n_samples_list)} sample counts, got {per_image.shape[1]}")
    vanishing_idxs = compute_vanishing_norms_idxs(per_image, n_samples_list=n_samples_list, norm=norm,
                                                  verbose=False)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    out_dir = os.path.join(plots_dir, "vanishing_gradients_heatmaps")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for im_idx in vanishing_idxs:
        fig = _vanishing_gradient_heatmap(plt, sns, np.squeeze(np.asarray(test_images[im_idx])),
                                          per_image[im_idx], n_samples_list, norm)
        path = os.path.join(out_dir, f"{filename}_vanGrad_{im_idx}.png")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths
