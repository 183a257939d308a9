from robustbnns_tpu_torch.parallel.distributed import host_identity, partition_for_host

__all__ = ["host_identity", "partition_for_host"]
