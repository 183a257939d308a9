"""The ranks of the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_mesh_api.py``).

Run as ``python tests/torch_mesh_worker.py SUITE RANK WORLD DIR``: the rank
joins a gloo group through a file store in ``DIR`` (no TCP port), loads the
inputs the test wrote to ``DIR/inputs.npz``, runs every case of ``SUITE`` and
saves each case's results to ``DIR/SUITE_RANK.pt``. It imports torch, numpy
and the port only. The test files import :func:`spawn`, the input helpers
and :func:`one_rank_mesh` from here.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, CLASSES, HIDDEN = (6, 6, 1), 10, 16
RANK_TIMEOUT_S = 120  # a hung collective fails its test instead of hanging the suite


def data(n, seed=0, shape=SHAPE):
    """Uniform images whose label is the brightest of ten pixel groups (learnable)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + shape).astype(np.float32)
    labels = x.reshape(n, -1)[:, :30].reshape(n, CLASSES, 3).sum(-1).argmax(-1)
    return x, np.eye(CLASSES, dtype=np.float32)[labels]


def tree_arrays(prefix: str, tree) -> dict:
    """A parameter tree (a sequence of ``{"w", "b"}`` dicts) as flat npz entries."""
    return {f"{prefix}/{i}/{k}": np.asarray(v, np.float32) for i, layer in enumerate(tree) for k, v in layer.items()}


def tree_from(arrays, prefix: str):
    """The port's tree of tensors from :func:`tree_arrays`'s entries."""
    layers = {}
    for name in arrays:
        if name.startswith(prefix + "/"):
            i, k = name[len(prefix) + 1:].split("/")
            layers.setdefault(int(i), {})[k] = torch.tensor(arrays[name])
    return tuple(layers[i] for i in sorted(layers))


def spawn(suite: str, world: int, workdir, inputs: dict) -> list:
    """Run ``world`` ranks of ``suite`` on ``inputs``; every rank's results."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r), str(world), workdir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {suite} exited with {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(workdir, f"{suite}_{r}.pt"), weights_only=False) for r in range(world)]


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank gloo mesh in this process, its group taken down afterwards."""
    import torch.distributed as dist

    from robustbnns_tpu_torch.parallel import make_mesh, set_default_mesh

    started = not dist.is_initialized()
    try:
        yield make_mesh(device="cpu")
    finally:
        set_default_mesh(None)
        if started and dist.is_initialized():
            dist.destroy_process_group()


def checksums(tensors) -> list:
    """Every rank's SHA-256 of ``tensors``' bytes, gathered on every rank."""
    import torch.distributed as dist

    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().contiguous().numpy().tobytes())
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, digest.hexdigest())
    return out


def leaves(tree) -> list:
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    return tree_leaves(tree)


# --------------------------------------------------------------------------- #
# Suite "parallel": the mesh module (tests/test_torch_parallel.py)
# --------------------------------------------------------------------------- #


def case_make_mesh(inp):
    from robustbnns_tpu_torch.parallel import make_mesh

    m21, m12 = make_mesh(n_data=2, n_sample=1, device="cpu"), make_mesh(n_sample=2, device="cpu")
    try:
        make_mesh(n_data=3, n_sample=2, device="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    return {"shapes": [m21.shape, m12.shape], "index": [m21.index("data"), m12.index("sample")], "error": error}


def case_shard_batch(inp):
    from robustbnns_tpu_torch.parallel import gather_axis, make_mesh, replicate, shard_axis, shard_batch

    import torch.distributed as dist

    m = make_mesh(n_data=2, n_sample=1, device="cpu")
    x = torch.arange(32.0).reshape(32, 1)
    local = shard_batch(x, m)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ragged = shard_axis(torch.arange(33.0), m)
    mine = (torch.full((3,), float(dist.get_rank())), {"b": torch.full((2,), 10.0 + dist.get_rank())})
    return {"local": local, "gathered": gather_axis(local, m, 32), "ragged": ragged,
            "warned": [str(w.message) for w in caught], "replicated": replicate(mine, m)}


def case_svi_step(inp):
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, elbo_step
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_svi_step

    arch = build_architecture("fc", "relu", (1, 2, 1), 2, 16)
    x, labels, eps = torch.tensor(inp["svi_x"]), torch.tensor(inp["svi_labels"]), tree_from(inp, "svi_eps")
    out = {}
    for name, mesh in (("mesh", make_mesh(n_data=2, device="cpu")), ("plain", None)):
        post = MeanFieldPosterior(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()}
                                          for layer in tree_from(inp, f"svi_{part}")) for part in ("loc", "rho")))
        opt = torch.optim.Adam(leaves(post.loc) + leaves(post.rho), lr=0.01, betas=(0.9, 0.999), eps=1e-8)
        if mesh is None:
            loss = elbo_step(arch.apply, opt, post, eps, x, labels)
        else:
            loss = sharded_svi_step(arch, opt, mesh)(post, x, labels, eps)
        out[name] = {"loss": loss, "leaves": [v.detach() for v in leaves(post.loc) + leaves(post.rho)]}
    out["checksums"] = checksums(out["mesh"]["leaves"])
    return out


def case_predict(inp):
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_predict

    arch = build_architecture("fc", "relu", (1, 2, 1), 2, 16)
    post = MeanFieldPosterior(tree_from(inp, "svi_loc"), tree_from(inp, "svi_rho"))
    x, eps = torch.tensor(inp["pred_x"]), tree_from(inp, "pred_eps")
    return {f"{nd}x{ns}": sharded_predict(arch, make_mesh(nd, ns, device="cpu"), 4)(post, x, eps)
            for nd, ns in ((2, 1), (1, 2))}


def case_attack_grads(inp):
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_attack_grads

    arch = build_architecture("fc", "relu", (1, 2, 1), 2, 16)
    params = tree_from(inp, "nn")
    grads = sharded_attack_grads(lambda x, g: arch.apply(params, x), make_mesh(2, device="cpu"))
    return grads(torch.tensor(inp["svi_x"]), torch.tensor(inp["svi_labels"]))


def case_hmc_chains(inp):
    from robustbnns_tpu_torch.inference.hmc import HMCConfig
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_hmc_chains

    cfg = HMCConfig(num_samples=200, warmup=50, step_size=0.3, num_steps=5)
    run = sharded_hmc_chains(lambda q: 0.5 * (q * q).sum(-1), make_mesh(1, 2, device="cpu"), cfg)
    samples, info = run(torch.zeros(2, 4), [11, 12])
    return {"samples": samples, "info": info}


def case_nuts_chains(inp):
    from robustbnns_tpu_torch.inference.nuts import NUTSConfig
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_nuts_chains

    cfg = NUTSConfig(num_samples=30, warmup=20, step_size=0.3, max_depth=4)
    run = sharded_nuts_chains(lambda q: 0.5 * (q * q).sum(-1), make_mesh(1, 2, device="cpu"), cfg)
    samples, info = run(torch.zeros(2, 4), [21, 22])
    return {"samples": samples, "info": info}


def _seeded_forward(inp):
    """An SVI fc predictive on the injected draws ``fgsm_eps`` (deterministic)."""
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.predict import svi_predict

    arch = build_architecture("fc", "leaky", (1, 2, 1), 2, 16)
    post = MeanFieldPosterior(tree_from(inp, "fgsm_loc"), tree_from(inp, "fgsm_rho"))
    eps = tree_from(inp, "fgsm_eps")
    return lambda x, generator=None: svi_predict(arch, post, x, eps)


def case_fgsm(inp):
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_fgsm

    run = sharded_fgsm(_seeded_forward(inp), make_mesh(2, device="cpu"))
    return run(torch.tensor(inp["fgsm_x"]), torch.tensor(inp["fgsm_labels"]), 0.3)


def case_pgd(inp):
    from robustbnns_tpu_torch.parallel import make_mesh, sharded_pgd

    run = sharded_pgd(_seeded_forward(inp), make_mesh(2, device="cpu"), iters=5)
    return run(torch.tensor(inp["fgsm_x"][:16]), torch.tensor(inp["fgsm_labels"][:16]), 0.2, 2.0)


# --------------------------------------------------------------------------- #
# Suite "api": the mesh= argument of every API (tests/test_torch_mesh_api.py)
# --------------------------------------------------------------------------- #

API_TRAIN = dict(epochs=2, lr=0.01, batch_size=64, verbose=False, device="cpu")


def case_svi_train(inp):
    from robustbnns_tpu_torch.inference.svi import svi_train
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh

    arch = build_architecture("fc2", "leaky", SHAPE, CLASSES, 32)
    post, hist = svi_train(arch, inp["x"], inp["y"], seed=0, train_acc_samples=2, mesh=make_mesh(2, device="cpu"),
                           **API_TRAIN)
    return {"leaves": leaves(post.loc) + leaves(post.rho), "loss": hist["loss"], "accuracy": hist["accuracy"],
            "checksums": checksums(leaves(post.loc) + leaves(post.rho))}


def case_train_nn(inp):
    from robustbnns_tpu_torch.models import build_architecture, train_nn
    from robustbnns_tpu_torch.parallel import make_mesh

    arch = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    model = train_nn(arch, inp["x"], inp["y"], seed=0, mesh=make_mesh(2, device="cpu"), **API_TRAIN)
    return {"leaves": leaves(model.params), "loss": model.history["loss"],
            "accuracy": model.history["accuracy"], "checksums": checksums(leaves(model.params))}


def case_train_ensemble(inp):
    from robustbnns_tpu_torch.models import build_architecture, train_ensemble
    from robustbnns_tpu_torch.parallel import make_mesh

    m12 = make_mesh(1, 2, device="cpu")
    fc = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    kwargs = dict(ensemble_size=4, epochs=2, lr=0.01, batch_size=64, verbose=False, device="cpu")
    out = {"fc": train_ensemble(fc, inp["x"], inp["y"], mesh=m12, **kwargs),
           "fc_chunked": train_ensemble(fc, inp["x"], inp["y"], mesh=m12, member_chunk=2, **kwargs),
           "fc_odd": train_ensemble(fc, inp["x"], inp["y"], mesh=m12, **{**kwargs, "ensemble_size": 3})}
    conv = build_architecture("conv", "leaky", (28, 28, 1), CLASSES, 16, "mnist")
    out["conv"] = train_ensemble(conv, inp["conv_x"], inp["conv_y"], ensemble_size=2, epochs=1, lr=0.01,
                                 batch_size=16, verbose=False, device="cpu", mesh=m12)
    result = {k: {"leaves": leaves(e.stacked_params), "loss": e.history["loss"]} for k, e in out.items()}
    result["checksums"] = checksums(leaves(out["fc"].stacked_params))
    return result


def make_bnn(inference, **cfg):
    """A fc2-16 BNN of ``inference`` on the CPU, its config ``cfg``."""
    from robustbnns_tpu_torch import config
    from robustbnns_tpu_torch.models.bnn import BNN

    return BNN.from_config(config.BNNConfig("mnist", HIDDEN, "leaky", "fc2", inference, **cfg), SHAPE, CLASSES,
                           device="cpu")


SVI_CFG = dict(epochs=2, lr=0.01)
# A fixed step (no warmup): adapted steps of near 1 make these short chains
# chaotic, and two roundings of one sum then part (tests/test_torch_mesh_api.py).
SAMPLER_CFG = {"hmc": dict(n_samples=6, warmup=0, step_size=0.01, num_steps=3),
               "nuts": dict(n_samples=3, warmup=0, step_size=0.1)}


def case_bnn_train(inp):
    from robustbnns_tpu_torch.parallel import get_default_mesh, make_mesh, use_mesh

    m = make_mesh(2, device="cpu")
    with use_mesh(m):
        svi = make_bnn("svi", **SVI_CFG).train(inp["x"], inp["y"], batch_size=64, train_acc_samples=0,
                                               verbose=False)
    restored = get_default_mesh() is None
    hmc, nuts = (make_bnn("hmc", **SAMPLER_CFG[s]).train(inp["x"], inp["y"], batch_size=128, mesh=m,
                                                         verbose=False, hmc_sampler=s) for s in ("hmc", "nuts"))
    return {"restored": restored, "svi": leaves(svi.posterior.loc) + leaves(svi.posterior.rho),
            "hmc": leaves(hmc.samples), "nuts": leaves(nuts.samples), "hmc_history": hmc.history,
            "nuts_history": nuts.history,
            "checksums": checksums(leaves(svi.posterior.loc) + leaves(hmc.samples) + leaves(nuts.samples))}


def _attack_bnn(inp):
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior

    bnn = make_bnn("svi", **SVI_CFG)
    bnn.posterior = MeanFieldPosterior(tree_from(inp, "bnn_loc"), tree_from(inp, "bnn_rho"))
    return bnn


def case_attacks(inp):
    from robustbnns_tpu_torch.attacks import attack, attack_evaluation
    from robustbnns_tpu_torch.parallel import make_mesh

    m = make_mesh(2, device="cpu")
    bnn = _attack_bnn(inp)
    x, y = inp["x"][:128], inp["y"][:128]
    out = {}
    for method, fused in (("fgsm", False), ("pgd", False), ("fgsm", True)):
        out[f"{method}_fused" if fused else method] = attack(
            bnn, x, y, method=method, n_samples=3, fused=fused, batch_size=64, mesh=m, save=False, verbose=False)
    out["ragged"] = attack(bnn, inp["x"][:69], inp["y"][:69], method="fgsm", n_samples=2, batch_size=64, mesh=m,
                           save=False, verbose=False)
    out["evaluation"] = attack_evaluation(bnn, x, out["fgsm"], y, n_samples=3, batch_size=64, mesh=m, verbose=False)
    out["fgsm_file"] = attack(bnn, x[:4], y[:4], method="fgsm", n_samples=3, mesh=m, filename="mesh_attack",
                              rel_path=os.path.join(str(inp["workdir"]), "files"), verbose=False)
    return out


def case_gradients(inp):
    from robustbnns_tpu_torch.analysis.gradients import expected_loss_gradients
    from robustbnns_tpu_torch.models import DeterministicNN, build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh

    bnn = _attack_bnn(inp)
    x, y = inp["x"][:64], inp["y"][:64]
    out = {f"{nd}x{ns}": expected_loss_gradients(bnn, x, y, n_samples=4, batch_size=32,
                                                 mesh=make_mesh(nd, ns, device="cpu"))
           for nd, ns in ((2, 1), (1, 2))}
    out["odd_draws"] = expected_loss_gradients(bnn, x, y, n_samples=3, batch_size=32,
                                               mesh=make_mesh(1, 2, device="cpu"))
    nn = DeterministicNN(build_architecture("fc2", "leaky", SHAPE, CLASSES, HIDDEN), tree_from(inp, "bnn_loc"))
    out["deterministic"] = expected_loss_gradients(nn, x, y, n_samples=None, batch_size=32,
                                                   mesh=make_mesh(2, device="cpu"))
    return out


def case_batched_eval(inp):
    from robustbnns_tpu_torch.parallel import make_mesh
    from robustbnns_tpu_torch.predict import batched_eval

    bnn = _attack_bnn(inp)
    fn = bnn.predictive_fn(n_samples=3, seeds=[0, 1, 2])
    return batched_eval(fn, torch.tensor(inp["x"][:100]), torch.tensor(inp["y"][:100]), batch_size=32,
                        mesh=make_mesh(2, device="cpu"))


def case_setup_device(inp):
    from robustbnns_tpu_torch.cli.common import setup_device
    from robustbnns_tpu_torch.parallel import get_default_mesh, set_default_mesh

    shapes = []
    for spec in ("2x1", "1x2", "2", "auto"):
        device = setup_device("cpu", spec)
        shapes.append((str(device), get_default_mesh().shape))
    set_default_mesh(None)
    os.environ["ROBUSTBNNS_MESH"] = "1x2"
    setup_device("cpu")
    shapes.append(("env", get_default_mesh().shape))
    del os.environ["ROBUSTBNNS_MESH"]
    set_default_mesh(None)
    return shapes


SUITES = {
    "parallel": [case_make_mesh, case_shard_batch, case_svi_step, case_predict, case_attack_grads,
                 case_hmc_chains, case_nuts_chains, case_fgsm, case_pgd],
    "api": [case_svi_train, case_train_nn, case_train_ensemble, case_bnn_train, case_attacks, case_gradients,
            case_batched_eval, case_setup_device],
}


def main(suite: str, rank: int, world: int, workdir: str) -> None:
    from robustbnns_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    if not initialize_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank, device="cpu"):
        raise RuntimeError("the rank joined no group")
    if any(m == "jax" or m.startswith(("jax.", "robustbnns_tpu.")) for m in sys.modules):
        raise RuntimeError("a rank imported JAX or the JAX package")
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inp = dict(f, workdir=workdir)
    results = {case.__name__[len("case_"):]: case(inp) for case in SUITES[suite]}
    torch.save(results, os.path.join(workdir, f"{suite}_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
