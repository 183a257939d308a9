from robustbnns_tpu_torch.ops.fused_predict import (
    fused_predictive_fn,
    supports_fused,
    svi_predict_fused,
)
from robustbnns_tpu_torch.ops.sampled_dense import (
    launch_counts,
    reset_launch_counts,
    sampled_dense,
    sampled_dense_dparams,
    sampled_dense_reference,
    sampled_dense_xs,
    sampled_dense_xs_dparams,
)

__all__ = [
    "sampled_dense",
    "sampled_dense_xs",
    "sampled_dense_reference",
    "sampled_dense_dparams",
    "sampled_dense_xs_dparams",
    "svi_predict_fused",
    "fused_predictive_fn",
    "supports_fused",
    "launch_counts",
    "reset_launch_counts",
]
