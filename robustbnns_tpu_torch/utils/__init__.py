from robustbnns_tpu_torch.utils.checkpoint import load_pytree, save_pytree, wait_for_checkpoints
from robustbnns_tpu_torch.utils.prng import key_from_seed, keys_from_seeds
from robustbnns_tpu_torch.utils.pytree import (
    flatten_tree_to_vector,
    index_tree,
    normal_like_tree,
    slice_tree,
    stack_trees,
    tree_map_with_path_names,
    tree_size,
)
from robustbnns_tpu_torch.utils.timing import Timer, execution_time, maybe_profile

__all__ = [
    "key_from_seed",
    "keys_from_seeds",
    "normal_like_tree",
    "tree_size",
    "stack_trees",
    "index_tree",
    "slice_tree",
    "flatten_tree_to_vector",
    "tree_map_with_path_names",
    "save_pytree",
    "load_pytree",
    "wait_for_checkpoints",
    "execution_time",
    "Timer",
    "maybe_profile",
]
