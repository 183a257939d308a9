"""Training curves (port of ``robustbnns_tpu/utils/plotting.py``, the slice's part).

matplotlib is imported inside the function, so nothing on the training or
attack path needs it.
"""
from __future__ import annotations

import os

CURVE_FIGSIZE = (12, 8)  # two stacked panels, reference utils.py:268


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
