"""Joining processes into one group, and work partitioning across independent
workers (port of ``robustbnns_tpu/parallel/distributed.py``).

The reference fans its grid out over joblib processes with disk as the only
channel (``grid_search_halfMoons.py:52-60``). Two tiers replace it:

* **one program across processes**: :func:`initialize_distributed` joins the
  processes that ``torchrun`` starts (one per card) into one
  ``torch.distributed`` group, over which every mesh of
  :mod:`robustbnns_tpu_torch.parallel.mesh` spans;
* **independent workers** (grid cells): each worker takes a deterministic
  round-robin share of the work list (:func:`partition_for_host`), and the
  checkpoints on disk are the only coordination: any worker can crash and be
  re-run.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join this process to a ``torch.distributed`` group.

    The arguments default to ``torchrun``'s environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method="env://"``), ``WORLD_SIZE`` and ``RANK``.
    ``coordinator_address`` is ``host:port`` (TCP) or a URL such as
    ``file:///path`` (a file store: no port). ``device="cuda"`` joins with
    NCCL on ``cuda:LOCAL_RANK`` and makes that card the current one;
    ``"cpu"`` joins with gloo.

    Returns True when this process is one of several in a group; False for
    the single-process no-op (no coordinator and at most one process), so a
    script can call it unconditionally. A group already joined is kept.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", (process_id or 0) % torch.cuda.device_count()))
        card = torch.device("cuda", local_rank)
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method=init_method, world_size=num_processes, rank=process_id,
                                device_id=card)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=num_processes, rank=process_id)
    return True


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
