"""Work partitioning across independent workers (port of
``robustbnns_tpu/parallel/distributed.py``: ``host_identity`` and
``partition_for_host``).

The reference fans its grid out over joblib processes with disk as the only
channel (``grid_search_halfMoons.py:52-60``). Here each worker takes a
deterministic round-robin share of the work list, and the checkpoints on disk
are the only coordination: any worker can crash and be re-run. Connecting
processes into one ``torch.distributed`` group (``initialize_distributed``)
waits for the parallelism slice.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence


def host_identity(host_id: Optional[int] = None, n_hosts: Optional[int] = None) -> tuple[int, int]:
    """This worker's ``(host_id, n_hosts)`` for work partitioning.

    Resolution order: explicit arguments → a live ``torch.distributed``
    process group of more than one rank (its rank and world size) →
    ``ROBUSTBNNS_HOST_ID``/``ROBUSTBNNS_N_HOSTS`` → ``(0, 1)``.
    """
    if host_id is not None and n_hosts is not None:
        return host_id, n_hosts
    if (host_id is None) != (n_hosts is None):
        # A lone --host_id resolving to (0, 1) would train the whole grid and
        # race its peers on the shared checkpoints.
        raise ValueError(
            "host_id and n_hosts must be given together "
            f"(got host_id={host_id}, n_hosts={n_hosts})"
        )
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    env_id = os.environ.get("ROBUSTBNNS_HOST_ID")
    env_n = os.environ.get("ROBUSTBNNS_N_HOSTS")
    if env_id is not None and env_n is not None:
        return int(env_id), int(env_n)
    return 0, 1


def partition_for_host(items: Sequence, host_id: Optional[int] = None, n_hosts: Optional[int] = None) -> list:
    """This worker's round-robin share of a work list: item i goes to worker
    ``i % n_hosts``, so every item lands on exactly one worker and the same
    ``n_hosts`` always gives the same shares (checkpoint resume stays valid)."""
    hid, n = host_identity(host_id, n_hosts)
    if not 0 <= hid < n:
        raise ValueError(f"host_id {hid} out of range for {n} hosts")
    return [item for i, item in enumerate(items) if i % n == hid]
