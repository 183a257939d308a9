from robustbnns_tpu_torch.data.datasets import load_dataset, onehot_to_labels
from robustbnns_tpu_torch.data.loaders import batch_arrays, classwise_arrays

__all__ = ["load_dataset", "onehot_to_labels", "batch_arrays", "classwise_arrays"]
