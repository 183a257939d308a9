from robustbnns_tpu_torch.inference.hmc import HMCConfig, HMCInfo, hmc_sample, hmc_train_batched
from robustbnns_tpu_torch.inference.nuts import NUTSConfig, NUTSInfo, nuts_sample
from robustbnns_tpu_torch.inference.svi import (
    MeanFieldPosterior,
    elbo_loss,
    gaussian_kl_to_std_normal,
    init_meanfield,
    sample_meanfield,
    svi_train,
)

__all__ = [
    "MeanFieldPosterior",
    "init_meanfield",
    "sample_meanfield",
    "gaussian_kl_to_std_normal",
    "elbo_loss",
    "svi_train",
    "HMCConfig",
    "HMCInfo",
    "hmc_sample",
    "hmc_train_batched",
    "NUTSConfig",
    "NUTSInfo",
    "nuts_sample",
]
