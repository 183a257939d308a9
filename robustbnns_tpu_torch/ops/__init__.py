# sampled_dense first: its counters lead build.LAUNCH_COUNTERS, so launch_counts() keeps its key order
from robustbnns_tpu_torch.ops.sampled_dense import (
    sampled_dense,
    sampled_dense_dparams,
    sampled_dense_reference,
    sampled_dense_xs,
    sampled_dense_xs_dparams,
)
from robustbnns_tpu_torch.ops.build import launch_counts, reset_launch_counts
from robustbnns_tpu_torch.ops.fused_predict import (
    fused_predictive_fn,
    supports_fused,
    svi_predict_fused,
)
from robustbnns_tpu_torch.ops.grouped_conv import grouped_conv

__all__ = [
    "grouped_conv",
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
