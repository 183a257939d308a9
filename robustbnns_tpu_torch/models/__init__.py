from robustbnns_tpu_torch.models.architectures import ACTIVATIONS, Architecture, build_architecture
from robustbnns_tpu_torch.models.bnn import BNN

__all__ = ["ACTIVATIONS", "Architecture", "build_architecture", "BNN"]
