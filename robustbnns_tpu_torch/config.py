"""Paths, the NN, BNN and multimodality zoos and typed configs (port of ``robustbnns_tpu/config.py``).

Same directory layout, the same ``ROBUSTBNNS_*`` environment overrides and the
same zoo indices and values, so checkpoint names line up 1:1 with the JAX
package and with the reference (``model_bnn.py:36-66``, ``savedir.py:4-6``).
Plain Python: nothing here touches torch.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

DATA = os.environ.get("ROBUSTBNNS_DATA", "data/")
PLOTS = os.environ.get("ROBUSTBNNS_PLOTS", "plots/")
TESTS = os.environ.get(
    "ROBUSTBNNS_TESTS", "tests_out/" + str(time.strftime("%Y-%m-%d")) + "/"
)


def resolve_rel_path(savedir: str) -> str:
    """Map the reference's ``--savedir DATA|TESTS`` flag to a directory."""
    return DATA if savedir == "DATA" else TESTS


@dataclasses.dataclass(frozen=True)
class NNConfig:
    """Hyperparameters of a deterministic NN (reference ``model_nn.py:19-31``)."""

    dataset: str
    hidden_size: int
    activation: str  # relu | leaky | sigm | tanh
    architecture: str  # fc | fc2 | conv | conv2 | resnet20 | cct7
    epochs: int
    lr: float

    @property
    def name(self) -> str:
        """Checkpoint identity string (reference ``model_nn.py:56-58``)."""
        return (
            f"{self.dataset}_nn_hid={self.hidden_size}_act={self.activation}"
            f"_arch={self.architecture}_ep={self.epochs}_lr={self.lr}"
        )


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    """Hyperparameters of an NN ensemble (reference ``model_ensemble.py:14-31``)."""

    dataset: str
    hidden_size: int
    activation: str
    architecture: str
    epochs: int
    lr: float
    ensemble_size: int
    batch_size: int = 100  # reference model_ensemble.py:73

    @property
    def name(self) -> str:
        return (
            f"{self.dataset}_ensemble_hid={self.hidden_size}_act={self.activation}"
            f"_arch={self.architecture}_size={self.ensemble_size}"
        )

    @classmethod
    def from_nn(cls, nn_cfg: NNConfig, ensemble_size: int) -> "EnsembleConfig":
        """The ensemble of ``ensemble_size`` members of one NN of the zoo."""
        return cls(dataset=nn_cfg.dataset, hidden_size=nn_cfg.hidden_size, activation=nn_cfg.activation,
                   architecture=nn_cfg.architecture, epochs=nn_cfg.epochs, lr=nn_cfg.lr,
                   ensemble_size=ensemble_size)


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    """Hyperparameters of a BNN (reference ``model_bnn.py:36-66``).

    ``inference`` selects the engine: ``svi`` uses (epochs, lr); ``hmc`` uses
    (n_samples, warmup, step_size, num_steps).
    """

    dataset: str
    hidden_size: int
    activation: str
    architecture: str
    inference: str  # svi | hmc
    epochs: Optional[int] = None
    lr: Optional[float] = None
    n_samples: Optional[int] = None
    warmup: Optional[int] = None
    step_size: float = 0.005  # reference model_bnn.py:73
    num_steps: int = 10

    def name(self, n_inputs: Optional[int] = None) -> str:
        """Checkpoint identity string (reference ``model_bnn.py:90-103``)."""
        name = (
            f"{self.dataset}_bnn_{self.inference}_hid={self.hidden_size}"
            f"_act={self.activation}_arch={self.architecture}"
        )
        if n_inputs:
            name += f"_inp={n_inputs}"
        if self.inference == "svi":
            return name + f"_ep={self.epochs}_lr={self.lr}"
        elif self.inference == "hmc":
            return (
                name
                + f"_samp={self.n_samples}_warm={self.warmup}"
                + f"_stepsize={self.step_size}_numsteps={self.num_steps}"
            )
        raise ValueError(f"unknown inference {self.inference!r}")


saved_NNs: dict[str, NNConfig] = {
    "model_0": NNConfig("mnist", 512, "leaky", "conv", 5, 0.01),
    "model_5": NNConfig("mnist", 512, "leaky", "fc2", 10, 0.01),
    "model_6": NNConfig("mnist", 256, "leaky", "conv", 10, 0.05),
    "model_7": NNConfig("mnist", 1024, "leaky", "fc2", 5, 0.02),
    "model_8": NNConfig("mnist", 1024, "leaky", "fc2", 10, 0.02),
    "model_9": NNConfig("mnist", 1024, "leaky", "conv", 10, 0.01),
}

saved_BNNs: dict[str, BNNConfig] = {
    "model_0": BNNConfig("mnist", 512, "leaky", "conv", "svi", epochs=5, lr=0.01),
    "model_1": BNNConfig("mnist", 512, "leaky", "fc2", "hmc", n_samples=100, warmup=50),
    "model_2": BNNConfig("fashion_mnist", 1024, "leaky", "conv", "svi", epochs=10, lr=0.001),
    "model_3": BNNConfig("fashion_mnist", 1024, "leaky", "fc2", "hmc", n_samples=100, warmup=50),
    "model_4": BNNConfig("fashion_mnist", 1024, "leaky", "conv", "svi", epochs=5, lr=0.01),
    "model_5": BNNConfig("mnist", 512, "leaky", "fc2", "svi", epochs=10, lr=0.01),
    "model_6": BNNConfig("mnist", 256, "leaky", "conv", "svi", epochs=10, lr=0.05),
    "model_7": BNNConfig("mnist", 1024, "leaky", "fc2", "svi", epochs=5, lr=0.02),
    "model_8": BNNConfig("mnist", 1024, "leaky", "conv", "svi", epochs=10, lr=0.02),
    "model_9": BNNConfig("fashion_mnist", 512, "leaky", "fc", "hmc", n_samples=100, warmup=100),
}

# HMC multimodality configs (reference test_multimodal.py:35-38); n_samples is a
# run-time argument there (--n_samples, default 50).
multimodal_BNNs: dict[str, BNNConfig] = {
    "model_10": BNNConfig("mnist", 512, "leaky", "fc2", "hmc", n_samples=50, warmup=100),
    "model_11": BNNConfig("fashion_mnist", 512, "leaky", "fc2", "hmc", n_samples=50, warmup=100),
}


def bnn_batch_size(cfg: BNNConfig) -> int:
    """Reference default batch size per inference engine (``model_bnn.py:403``)."""
    return 5000 if cfg.inference == "hmc" else 128
