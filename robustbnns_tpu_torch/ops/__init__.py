from robustbnns_tpu_torch.ops import grouped_conv as _grouped_conv_module
from robustbnns_tpu_torch.ops import grouped_conv3x3 as _grouped_conv3x3_module
from robustbnns_tpu_torch.ops import sampled_dense as _sampled_dense_module
from robustbnns_tpu_torch.ops.fused_predict import (
    fused_predictive_fn,
    supports_fused,
    svi_predict_fused,
)
from robustbnns_tpu_torch.ops.grouped_conv import grouped_conv
from robustbnns_tpu_torch.ops.grouped_conv3x3 import grouped_conv3x3
from robustbnns_tpu_torch.ops.sampled_dense import (
    sampled_dense,
    sampled_dense_dparams,
    sampled_dense_reference,
    sampled_dense_xs,
    sampled_dense_xs_dparams,
)


def launch_counts() -> dict[str, int]:
    """Every hand-written kernel's launches: each sampled-dense wrapper's by
    its name, the grouped conv's as ``grouped_conv.fwd``, and the grouped
    3×3 conv's as ``grouped_conv3x3.fwd`` and ``grouped_conv3x3.dgrad``."""
    return {**_sampled_dense_module.launch_counts(), **_grouped_conv_module.launch_counts(),
            **_grouped_conv3x3_module.launch_counts()}


def reset_launch_counts() -> None:
    _sampled_dense_module.reset_launch_counts()
    _grouped_conv_module.reset_launch_counts()
    _grouped_conv3x3_module.reset_launch_counts()


__all__ = [
    "grouped_conv",
    "grouped_conv3x3",
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
