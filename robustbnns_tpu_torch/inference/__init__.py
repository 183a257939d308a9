from robustbnns_tpu_torch.inference.hmc import HMCConfig, HMCInfo, hmc_sample, hmc_train_batched
from robustbnns_tpu_torch.inference.nuts import NUTSConfig, NUTSInfo, nuts_sample
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_train

__all__ = [
    "MeanFieldPosterior",
    "svi_train",
    "HMCConfig",
    "HMCInfo",
    "hmc_sample",
    "hmc_train_batched",
    "NUTSConfig",
    "NUTSInfo",
    "nuts_sample",
]
