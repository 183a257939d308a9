from robustbnns_tpu_torch.models.architectures import ACTIVATIONS, Architecture, build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.models.ensemble import EnsembleNN, train_ensemble
from robustbnns_tpu_torch.models.nn import DeterministicNN, cross_entropy, evaluate_nn, train_nn

__all__ = [
    "ACTIVATIONS",
    "Architecture",
    "build_architecture",
    "BNN",
    "DeterministicNN",
    "cross_entropy",
    "train_nn",
    "evaluate_nn",
    "EnsembleNN",
    "train_ensemble",
]
