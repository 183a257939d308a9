from robustbnns_tpu_torch.analysis.gradients import (
    compute_vanishing_norms_idxs,
    expected_loss_gradients,
    load_loss_gradients,
    loss_gradients,
    save_loss_gradients,
)

__all__ = [
    "expected_loss_gradients",
    "loss_gradients",
    "save_loss_gradients",
    "load_loss_gradients",
    "compute_vanishing_norms_idxs",
]
