"""Device meshes and sharding over ``torch.distributed`` (port of
``robustbnns_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process owns every device of a
``Mesh("data", "sample")`` and XLA inserts the collectives. Here, as PyTorch
does it, there is one process per device (``torchrun``), and the collectives
are explicit. The two axes are the JAX package's:

* ``data``: a batch's rows split over the ranks; a sum over rows (an ELBO,
  an HMC potential and its gradient, a correct count) is each rank's partial
  sum and one ``all_reduce``;
* ``sample``: ensemble members, HMC/NUTS chains and the draws of the
  expected loss gradients split over the ranks.

The contract is JAX's: every function with ``mesh=`` returns, on every rank,
what the same call returns without a mesh (full tensors, not shards). At one
rank the result is bit-equal; at several, the sums are split in another
order and agree within f32 rounding. Every rank's generator steps in
lockstep (the same seed, the same calls), and a sharded item (a member, a
chain, a draw) draws from its own seed, so the layout changes no number.
A term that is not a sum over rows (the SVI KL, HMC's Gaussian prior) is
added on ``data`` index 0 only. Files are written by rank 0, then all ranks
meet at a barrier (:func:`write_on_rank_zero`).

A mesh always runs its collectives, at one rank too: with no group and one
process, :func:`make_mesh` starts a one-rank group on an in-process store.
The backend is NCCL for ``cuda`` and gloo for ``cpu``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

AXES = ("data", "sample")


class Mesh:
    """A ``(data, sample)`` grid over the ranks of the live group: a
    :class:`torch.distributed.device_mesh.DeviceMesh` with the JAX mesh's
    ``axis_names`` and ``shape`` (a dict: ``mesh.shape["data"]``)."""

    axis_names = AXES

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = {name: int(n) for name, n in zip(AXES, device_mesh.mesh.shape)}
        cuda = device_mesh.device_type == "cuda"
        self.device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")

    def index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.device_mesh.get_local_rank(name)

    def group(self, name: str):
        """The process group of the ranks that share this rank's other coordinate."""
        return self.device_mesh.get_group(name)

    def check(self, device) -> None:
        """Refuse tensors on another kind of device than the mesh's backend
        serves (a gloo group on CUDA tensors would hide the card)."""
        if torch.device(device).type != self.device.type:
            raise ValueError(f"a {self.device.type} mesh cannot reduce {torch.device(device).type} tensors")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _init_one_rank(device: torch.device) -> None:
    """A one-rank group on an in-process store: no port, no environment."""
    if device.type == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_data: Optional[int] = None, n_sample: int = 1, device=None) -> Mesh:
    """A ``(data, sample)`` mesh over the ranks of the live group.

    Defaults to all ranks on ``data``, the layout of batched training and
    attacks. With no group yet, joins ``torchrun``'s
    (:func:`.distributed.initialize_distributed`), or in a single process
    starts a one-rank group. ``device`` (``cuda`` or ``cpu``) defaults to the
    group's backend (NCCL: ``cuda``), else ``cuda``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    from robustbnns_tpu_torch.parallel.distributed import initialize_distributed
    from robustbnns_tpu_torch.utils.device import resolve_device

    if device is None:
        device = "cpu" if dist.is_initialized() and dist.get_backend() == "gloo" else "cuda"
    device = resolve_device(device)
    if not dist.is_initialized() and not initialize_distributed(device=device):
        _init_one_rank(device)
    backend = dist.get_backend()
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {device.type} mesh needs {'nccl' if device.type == 'cuda' else 'gloo'}, "
                         f"the group runs {backend}")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_sample
    if n_data * n_sample != world:
        raise ValueError(f"mesh {n_data}x{n_sample} != {world} ranks")
    return Mesh(init_device_mesh(device.type, (n_data, n_sample), mesh_dim_names=AXES))


# --------------------------------------------------------------------------- #
# Process-wide default mesh
# --------------------------------------------------------------------------- #

_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Install a process-wide default mesh; returns the previous one.

    Every API with a ``mesh=`` parameter falls back to it when ``mesh`` is not
    passed, so one ``set_default_mesh(make_mesh())`` at program start shards a
    whole script (``--mesh`` in the CLIs). ``None`` uninstalls.
    """
    global _DEFAULT_MESH
    previous = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    return previous


def get_default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


class use_mesh:
    """Context manager: ``with use_mesh(mesh): ...`` scopes the default mesh."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        self._previous = set_default_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_default_mesh(self._previous)
        return False


def resolve_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh to use: the explicit argument, else the process default."""
    return mesh if mesh is not None else _DEFAULT_MESH


# --------------------------------------------------------------------------- #
# Placement and collectives
# --------------------------------------------------------------------------- #

_REPLICATION_WARNED: set = set()


def shard_axis(x: torch.Tensor, mesh: Mesh, axis: int = 0, name: str = "data") -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis``, split over mesh
    axis ``name``; the whole of ``x`` (replicated) where the dimension does not
    divide, with a warning once per ``(dim, axis name, size)``: a ragged tail is
    expected, but a dimension that never divides runs at one rank's speed."""
    n, size = x.shape[axis], mesh.shape[name]
    if n % size:
        sig = (int(n), name, size)
        if sig not in _REPLICATION_WARNED:
            _REPLICATION_WARNED.add(sig)
            warnings.warn(
                f"shard_axis: dimension {n} does not divide mesh axis {name!r} ({size} ranks): "
                "replicating instead of sharding (one rank's throughput for this array). Pad or "
                "pick a divisible batch or sample count to parallelize.",
                stacklevel=2,
            )
        return x
    k = n // size
    return x.narrow(axis, mesh.index(name) * k, k)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x``: its leading axis split over ``data``."""
    return shard_axis(x, mesh, 0, "data")


def gather_axis(local: torch.Tensor, mesh: Mesh, n: int, axis: int = 0, name: str = "data") -> torch.Tensor:
    """Undo :func:`shard_axis` of a dimension of size ``n``: every rank's
    block concatenated along ``axis``, on every rank (one all-gather over
    ``name``); a replicated ``local`` comes back as it is."""
    size = mesh.shape[name]
    if n % size:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=mesh.group(name))
    return torch.cat(parts, axis)


def split_rows(n: int, mesh: Mesh, name: str = "data") -> slice:
    """This rank's contiguous share of ``n`` items whose results are summed:
    ``[i·n // size, (i+1)·n // size)``. Shares may differ by one item, and are
    empty where ``n < size``; nothing is replicated, so nothing is counted twice."""
    size, i = mesh.shape[name], mesh.index(name)
    return slice(i * n // size, (i + 1) * n // size)


def reduce_sum(tensors: list, mesh: Mesh, name: str = "data") -> list:
    """Each tensor summed over the ranks of axis ``name``, in one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(name))
    return [part.view(t.shape) for part, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def sum_gradients(loss: torch.Tensor, leaves: list, mesh: Mesh, name: str = "data") -> torch.Tensor:
    """After ``loss.backward()`` on this rank's share of a sum: the loss and
    every leaf's gradient summed over axis ``name`` in one flat all-reduce
    (a leaf with no gradient adds zeros), each sum set as the leaf's
    gradient. Returns the summed loss."""
    grads = [v.grad if v.grad is not None else torch.zeros_like(v) for v in leaves]
    loss, *grads = reduce_sum([loss.detach()] + grads, mesh, name)
    for v, g in zip(leaves, grads):
        v.grad = g
    return loss


def _map_tensors(fn: Callable, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def replicate(tree, mesh: Mesh):
    """A copy of a tree of tensors (parameters, a posterior, a position) with
    rank 0's values on every rank of the mesh: one broadcast a leaf."""

    def bcast(t):
        mesh.check(t.device)
        t = t.detach().clone()
        dist.broadcast(t, src=0)
        return t

    return _map_tensors(bcast, tree)


def run_on_rows(fn: Callable, mesh: Mesh, *arrays):
    """``fn(*arrays)`` with every tensor of ``arrays`` whose leading axis has
    the first one's length cut to this rank's rows (:func:`shard_axis` over
    ``data``; other arguments pass whole), and its row-wise result gathered
    back on every rank. Rows are independent (an attack, an input gradient),
    so no sum crosses ranks; a row count that does not divide runs whole on
    every rank."""
    n = arrays[0].shape[0]
    local = [shard_batch(a, mesh) if torch.is_tensor(a) and a.dim() and a.shape[0] == n else a for a in arrays]
    return gather_axis(fn(*local), mesh, n)


def write_on_rank_zero(write: Callable, mesh: Optional[Mesh] = None):
    """``write()`` (a file write) on rank 0 only when a mesh (``mesh`` or the
    default) is in use, then a barrier of all ranks, so ranks never race on
    one path and every rank can read the file after; without a mesh every
    process writes. Returns ``write()``'s result on rank 0, else None."""
    mesh = resolve_mesh(mesh)
    if mesh is None:
        return write()
    out = write() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


# --------------------------------------------------------------------------- #
# Sharded compute paths
# --------------------------------------------------------------------------- #


def sharded_svi_step(arch, optimizer, mesh: Mesh):
    """A data-parallel SVI step: ``step(posterior, x, labels, eps, mask=None)
    -> loss``. The batch's rows split over ``data``; the KL is added once; the
    loss and gradients are summed over ``data`` in one all-reduce; then
    ``optimizer`` (over the posterior's leaves) steps on every rank alike.
    ``eps`` is the step's noise tree (JAX draws it from a key)."""
    from robustbnns_tpu_torch.inference.svi import elbo_step

    def step(posterior, x, labels, eps, mask=None):
        return elbo_step(arch.apply, optimizer, posterior, eps, x, labels, mask, mesh)

    return step


def sharded_predict(arch, mesh: Mesh, n_samples: int):
    """Posterior predictive ``predict(posterior, x, eps) -> (batch, classes)``
    with the S draws of ``eps`` (a stacked ``(S, ...)`` noise tree) split over
    ``sample`` and the rows over ``data``: each rank averages the softmax of
    its draws on its rows, the averages are summed over ``sample`` weighted by
    their draw counts, and the rows gathered over ``data``."""
    from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
    from robustbnns_tpu_torch.utils.pytree import map_params

    def predict(posterior, x, eps):
        mesh.check(x.device)
        s = split_rows(n_samples, mesh, "sample")
        local_eps = map_params(lambda e: e[s], eps)

        def rows(xs):
            n_local = s.stop - s.start
            if n_local == 0:
                probs = xs.new_zeros((xs.shape[0], arch.output_size))
            else:
                w = sample_meanfield_eps(posterior, local_eps)
                probs = torch.softmax(arch.apply(w, xs), dim=-1).mean(dim=0) * (n_local / n_samples)
            return reduce_sum([probs], mesh, "sample")[0]

        return run_on_rows(rows, mesh, x)

    return predict


def sharded_hmc_chains(potential_fn, mesh: Mesh, config):
    """Chain-parallel HMC: ``run(init_positions, seeds) -> (samples, info)``.

    The C chains (``init_positions`` ``(C, D)``, one integer seed each) split
    over ``sample``; a rank runs its chains as one batched chain whose chain c
    draws from a generator seeded with ``seeds[c]`` alone
    (:class:`.inference.hmc.ChainDraws`), so a chain's numbers do not depend
    on the layout. Chains share nothing; the samples ``(C, S, D)`` and the
    per-chain info are gathered, the evaluations summed.
    """
    from robustbnns_tpu_torch.inference.hmc import ChainDraws, HMCInfo, _seeded_draws, hmc_sample

    def run(init_positions, seeds):
        mesh.check(init_positions.device)
        c = init_positions.shape[0]
        q0 = shard_axis(init_positions, mesh, 0, "sample")
        local_seeds = shard_axis(torch.as_tensor(list(seeds)), mesh, 0, "sample").tolist()
        draws = ChainDraws([_seeded_draws(s, q0.device) for s in local_seeds])
        samples, info = hmc_sample(potential_fn, q0, None, config._replace(num_chains=q0.shape[0]), draws=draws)
        evaluations = info.evaluations if q0.shape[0] == c else _sum_int(info.evaluations, mesh, q0.device)
        gathered = [gather_axis(t, mesh, c, 0, "sample") for t in (samples, *info[:3])]
        return gathered[0], HMCInfo(*gathered[1:], evaluations)

    return run


def sharded_nuts_chains(potential_fn, mesh: Mesh, config):
    """Chain-parallel NUTS: as :func:`sharded_hmc_chains`, each rank's chains
    run one after another (as :func:`.inference.nuts.nuts_sample` runs
    chains), chain c from a generator seeded with ``seeds[c]``."""
    from robustbnns_tpu_torch.inference.hmc import _seeded_draws
    from robustbnns_tpu_torch.inference.nuts import NUTSInfo, nuts_sample

    def run(init_positions, seeds):
        mesh.check(init_positions.device)
        c = init_positions.shape[0]
        q0 = shard_axis(init_positions, mesh, 0, "sample")
        local_seeds = shard_axis(torch.as_tensor(list(seeds)), mesh, 0, "sample").tolist()
        draws = [_seeded_draws(s, q0.device) for s in local_seeds]
        one = q0.shape[0] == 1  # nuts_sample takes and returns one chain without its chain axis
        samples, info = nuts_sample(potential_fn, q0[0] if one else q0, None,
                                    config._replace(num_chains=q0.shape[0]), draws=draws)
        if one:
            samples, info = samples[None], NUTSInfo(*(v[None] for v in info[:5]), info.evaluations)
        evaluations = info.evaluations if q0.shape[0] == c else _sum_int(info.evaluations, mesh, q0.device)
        gathered = [gather_axis(t, mesh, c, 0, "sample") for t in (samples, *info[:5])]
        return gathered[0], NUTSInfo(*gathered[1:], evaluations)

    return run


def _sum_int(value: int, mesh: Mesh, device) -> int:
    return int(reduce_sum([torch.tensor([float(value)], device=device)], mesh, "sample")[0])


def sharded_attack_grads(forward_fn, mesh: Mesh):
    """Input gradients with the attack set's rows split over ``data``:
    ``grads(x, labels, generator=None)``, gathered on every rank. Each rank
    differentiates its own rows; the draws of ``forward_fn`` come from
    ``generator``, in lockstep on every rank."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients

    def grads(x, labels, generator=None):
        mesh.check(x.device)
        return run_on_rows(lambda xs, ls: _input_gradients(forward_fn, xs, ls, generator), mesh, x, labels)

    return grads


def sharded_fgsm(forward_fn, mesh: Mesh):
    """Data-parallel FGSM: ``run(x, labels, epsilon, generator=None)``, the
    rows over ``data`` (:func:`.attacks.gradient_attacks.fgsm_attack` with
    ``mesh``)."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import fgsm_attack

    def run(x, labels, epsilon, generator=None):
        return fgsm_attack(forward_fn, x, labels, epsilon=epsilon, generator=generator, mesh=mesh)

    return run


def sharded_pgd(forward_fn, mesh: Mesh, iters: int = 40):
    """Data-parallel PGD: ``run(x, labels, epsilon, alpha, generator=None)``,
    the rows over ``data`` (reference semantics: fresh draws every iteration,
    projection, clamp)."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import pgd_attack

    def run(x, labels, epsilon, alpha, generator=None):
        return pgd_attack(forward_fn, x, labels, epsilon=epsilon, alpha=alpha, iters=iters, generator=generator,
                          mesh=mesh)

    return run
