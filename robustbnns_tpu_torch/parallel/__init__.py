"""Parallelism: one ``torch.distributed`` group over processes (one per
card), ``(data, sample)`` meshes over it, and the mesh paths of the package's
APIs (port of ``robustbnns_tpu/parallel``)."""
from robustbnns_tpu_torch.parallel.distributed import host_identity, initialize_distributed, partition_for_host
from robustbnns_tpu_torch.parallel.mesh import (
    Mesh,
    gather_axis,
    get_default_mesh,
    make_mesh,
    replicate,
    resolve_mesh,
    set_default_mesh,
    shard_axis,
    shard_batch,
    sharded_attack_grads,
    sharded_fgsm,
    sharded_hmc_chains,
    sharded_nuts_chains,
    sharded_pgd,
    sharded_predict,
    sharded_svi_step,
    use_mesh,
)

__all__ = [
    "initialize_distributed",
    "host_identity",
    "partition_for_host",
    "make_mesh",
    "shard_batch",
    "shard_axis",
    "replicate",
    "set_default_mesh",
    "get_default_mesh",
    "use_mesh",
    "resolve_mesh",
    "sharded_svi_step",
    "sharded_predict",
    "sharded_attack_grads",
    "sharded_hmc_chains",
    "sharded_nuts_chains",
    "sharded_fgsm",
    "sharded_pgd",
    "Mesh",
    "gather_axis",
]
