from robustbnns_tpu_torch.data.datasets import (
    labels_to_onehot,
    load_cifar,
    load_dataset,
    load_fashion_mnist,
    load_half_moons,
    load_mnist,
    onehot_to_labels,
)
from robustbnns_tpu_torch.data.loaders import Batches, batch_arrays, classwise_arrays

__all__ = [
    "load_dataset",
    "load_half_moons",
    "load_mnist",
    "load_fashion_mnist",
    "load_cifar",
    "labels_to_onehot",
    "onehot_to_labels",
    "Batches",
    "batch_arrays",
    "classwise_arrays",
]
