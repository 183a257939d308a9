#!/usr/bin/env python3
"""What NCCL puts on the card for each collective the port's mesh path uses,
at one rank (the card's machine has one GPU).

Run on a machine with a CUDA card, from the repo root::

    python3 scripts/torch_nccl_probe.py

It joins a one-rank NCCL group on an in-process store (no port), builds a
``(data, sample)`` device mesh of shape (1, 1), and traces each collective
with ``torch.profiler``: an in-place SUM all-reduce, an AVG all-reduce, a
list all-gather, a tensor all-gather, a broadcast and an all-to-all. It
prints the device events of each and the card's name and power limit.
"""
from __future__ import annotations

import subprocess

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.profiler import ProfilerActivity, profile


def device_events(fn) -> list[str]:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names.append(e.name)
    return sorted(set(names))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL {torch.cuda.nccl.version()}")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "sample"))
    data = mesh.get_group("data")
    x = torch.randn(1 << 20, device="cuda")
    out = torch.empty_like(x)
    probes = {
        "all_reduce SUM in place": lambda: dist.all_reduce(x, group=data),
        "all_reduce AVG in place": lambda: dist.all_reduce(x, op=dist.ReduceOp.AVG, group=data),
        "all_gather list": lambda: dist.all_gather([out], x, group=data),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out, x, group=data),
        "broadcast": lambda: dist.broadcast(x, src=0),
        "all_to_all_single": lambda: dist.all_to_all_single(out, x, group=data),
    }
    for name, fn in probes.items():
        print(f"[nccl-probe] {name}: {device_events(fn)}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
