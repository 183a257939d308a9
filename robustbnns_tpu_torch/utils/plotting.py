"""Training curves and image grids (port of ``robustbnns_tpu/utils/plotting.py``).

matplotlib is imported inside the functions, so nothing on the training or
attack path needs it.

The reference's grid dump iterates subplot slots ``range(1, rows*cols)``
(``utils.py:280``), skipping image 0 and leaving the last cell empty; as in
the JAX package, the grid here shows images ``0 .. side²-1``.
"""
from __future__ import annotations

import math
import os

import numpy as np

CURVE_FIGSIZE = (12, 8)  # two stacked panels, reference utils.py:268
GRID_FIGSIZE = (8, 8)  # square image grid, reference utils.py:278
GRID_MAX_SIDE = 10  # at most a 10x10 grid, reference utils.py:279


def plot_loss_accuracy(history: dict, path: str) -> str:
    """Stacked per-epoch curves, one panel per metric in ``history`` ("loss"
    over "accuracy", reference ``utils.py:267-274``), saved to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = [m for m in ("loss", "accuracy") if m in history]
    fig, axes = plt.subplots(len(metrics), figsize=CURVE_FIGSIZE, squeeze=False)
    for ax, metric in zip(axes[:, 0], metrics):
        ax.plot(history[metric])
        ax.set_title(metric)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def _as_2d(image: np.ndarray) -> np.ndarray:
    """An image squeezed to 2-D for ``imshow``; a 1-D one (a Half Moons point,
    ``(1, 2, 1)``) becomes one row of pixels."""
    image = np.squeeze(image)
    return image[None, :] if image.ndim == 1 else image


def plot_save_grid_images(images, filename: str, savedir: str) -> str:
    """A square grid of the first ``side²`` images (side ≤ 10) saved as
    ``<savedir>/<filename>`` (reference ``adversarialAttacks.py:135-141`` via
    ``utils.py:276-290``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    side = max(1, min(math.isqrt(len(images)), GRID_MAX_SIDE))
    fig, axes = plt.subplots(side, side, figsize=GRID_FIGSIZE, squeeze=False)
    for idx, ax in enumerate(axes.ravel()):
        if idx < len(images):
            ax.imshow(_as_2d(images[idx]))
        ax.set_axis_off()
    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, filename)
    fig.savefig(path)
    plt.close(fig)
    return path
