from robustbnns_tpu_torch.data.datasets import load_dataset
from robustbnns_tpu_torch.data.loaders import batch_arrays

__all__ = ["load_dataset", "batch_arrays"]
