"""Deterministic NNs and NN ensembles (``models/nn.py``, ``models/ensemble.py``,
``predict.py``) against the JAX package's.

* ``cross_entropy``, the forwards, ``predictive_fn``, ``evaluate_nn`` and
  ``EnsembleNN.evaluate`` on the same parameters: f32 parity at 1e-6 of the
  largest entry for fc2 and 1e-5 for conv (whose second convolution sums 800
  products per output; 1.6e-6 seen), accuracies equal;
* the ensemble averages raw logits (JAX ``ensemble_predict``), not
  probabilities, and its stacked ``apply`` equals a loop over members;
* ``train_nn`` and ``train_ensemble`` against JAX's with JAX's initial
  parameters and permutations injected. ``torch.optim.Adam`` rounds
  m̂/(√v̂ + eps) in another order than optax, and an update is near ±lr
  whatever the gradient's scale, so an entry whose gradient is near 0 can
  move by a little more or less per step (``tests/test_torch_svi.py``): the
  parameters agree to 1e-3·lr (fc2) and 2e-3·lr (a conv NN), the logged
  losses to 1e-5 relative, the accuracies to one row. A conv ensemble's
  members: 99% of each member's entries to 2e-3·lr, every entry to 0.2·lr.
  A member's batches can hold a rounding-sensitive event: member 2 of seed 5,
  trained in the batched step, parts from the same member trained alone in
  the port (and from JAX's, which agree with it to 4e-3·lr): 103 of its
  21,498 entries beyond 2e-3·lr after three steps, the largest 0.09·lr, in
  the second convolution; with the members reordered the part follows the
  member's data, not its position;
* ``member_chunk`` changes no member's numbers: bit-equal for fc2; for conv
  within 1e-3·lr, since the CPU's grouped convolutions sum in an order that
  depends on the number of groups (5e-4·lr seen); checkpoints cross packages
  both ways; a one-rank ``mesh=`` changes no bit.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.models import DeterministicNN as JaxNN
from robustbnns_tpu.models import EnsembleNN as JaxEnsemble
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.models import evaluate_nn as jax_evaluate_nn
from robustbnns_tpu.models import train_ensemble as jax_train_ensemble
from robustbnns_tpu.models import train_nn as jax_train_nn
from robustbnns_tpu.models.nn import cross_entropy as jax_cross_entropy
from robustbnns_tpu.predict import ensemble_predict as jax_ensemble_predict
from robustbnns_tpu_torch.models import (
    DeterministicNN,
    EnsembleNN,
    build_architecture,
    cross_entropy,
    evaluate_nn,
    train_ensemble,
    train_nn,
)
from robustbnns_tpu_torch.predict import ensemble_predict, nn_predict
from robustbnns_tpu_torch.utils.checkpoint import params_from_numpy
from robustbnns_tpu_torch.utils.pytree import tree_leaves

CLASSES = 10
SHAPES = {"fc2": (6, 6, 1), "conv": (28, 28, 1)}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


OF_MAX = {"fc2": 1e-6, "conv": 1e-5}


def close(got, want, of_max=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=of_max * np.abs(want).max())


def data(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + shape).astype(np.float32)
    return x, np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]


def archs(name, hidden=16):
    shape = SHAPES[name]
    return (jax_build(name, "leaky", shape, CLASSES, hidden, "mnist"),
            build_architecture(name, "leaky", shape, CLASSES, hidden, "mnist"))


def stacked_members(jarch, n):
    return to_np(jax.vmap(jarch.init)(jax.random.split(jax.random.key(11), n)))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, CLASSES)) * 4).astype(np.float32)
    labels = rng.integers(0, CLASSES, (3, 7))
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    for m in (None, mask):
        want = [float(jax_cross_entropy(logits[e], labels[e], m)) for e in range(3)]
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(float(cross_entropy(torch.from_numpy(logits[1]), torch.from_numpy(labels[1]),
                                                       None if m is None else torch.from_numpy(m))), want[1], rtol=1e-6)
    zero = cross_entropy(torch.from_numpy(logits[0]), torch.from_numpy(labels[0]), torch.zeros(7))
    assert float(zero) == float(jax_cross_entropy(logits[0], labels[0], np.zeros(7, np.float32))) == 0.0


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_nn_forward_predictive_and_evaluate_match_jax(name):
    """The same parameters in both packages: logits, ``nn_predict``, the
    memoized ``predictive_fn`` (ignoring the predictive's other arguments)
    and ``evaluate_nn`` with a padded last batch."""
    jarch, tarch = archs(name)
    params = to_np(jarch.init(jax.random.key(3)))
    ref, ours = JaxNN(arch=jarch, params=params), DeterministicNN(tarch, params_from_numpy(params))
    assert ours.device == torch.device("cpu")
    x, y = data(13, SHAPES[name])
    tx = torch.from_numpy(x)
    want = np.asarray(ref.forward(x))
    close(ours.forward(tx, n_samples=5, avg_posterior=True), want, OF_MAX[name])
    close(ours.logits(tx), want, OF_MAX[name])
    close(nn_predict(tarch, ours.params, tx), want, OF_MAX[name])
    fn = ours.predictive_fn(n_samples=3)
    assert fn is ours.predictive_fn()
    close(fn(tx, torch.Generator()), want, OF_MAX[name])
    assert evaluate_nn(ours, x, y, batch_size=4, verbose=False) == jax_evaluate_nn(ref, x, y, batch_size=4,
                                                                                   verbose=False)


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_ensemble_averages_raw_logits_like_jax(name):
    """``logits`` is the mean of the members' raw logits (JAX
    ``ensemble_predict``), within 1e-6 of a loop over members, and not the
    mean of their probabilities; ``n_samples`` takes the first members, past
    ``ensemble_size`` it raises; ``evaluate`` at batch 64 equals JAX's."""
    jarch, tarch = archs(name)
    members = stacked_members(jarch, 4)
    ref = JaxEnsemble(arch=jarch, stacked_params=members, ensemble_size=4)
    ours = EnsembleNN(tarch, params_from_numpy(members), 4)
    x, y = data(70, SHAPES[name], seed=1)
    tx = torch.from_numpy(x)
    for n in (None, 1, 3):
        want = np.asarray(jax_ensemble_predict(jarch, members, x, 4 if n is None else n))
        close(ours.forward(tx, n_samples=n), want, OF_MAX[name])
        close(ours.predictive_fn(n_samples=n)(tx), want, OF_MAX[name])
        close(ensemble_predict(tarch, ours.stacked_params, tx, 4 if n is None else n), want, OF_MAX[name])
    loop = torch.stack([tarch.apply(tuple({k: v[e] for k, v in layer.items()} for layer in ours.stacked_params), tx)
                        for e in range(4)])
    close(ours.member_logits(tx), loop, OF_MAX[name])
    close(ours.logits(tx), loop.mean(0), OF_MAX[name])
    # With heads scaled up the members disagree sharply: the softmax of the
    # mean logits is then far from the mean of the members' softmax.
    sharp = EnsembleNN(tarch, tuple({k: v * (30.0 if i == len(members) - 1 else 1.0) for k, v in layer.items()}
                                    for i, layer in enumerate(ours.stacked_params)), 4)
    probs = torch.softmax(sharp.member_logits(tx), -1).mean(0)
    assert float((torch.softmax(sharp.logits(tx), -1) - probs).abs().max()) > 0.05
    with pytest.raises(ValueError, match="Maximum number of samples"):
        ours.predictive_fn(n_samples=5)
    assert ours.evaluate(x, y, verbose=False) == ref.evaluate(x, y, verbose=False)


TRAIN = {"fc2": dict(n=50, batch=16, epochs=2, lr=1e-2, of_lr=1e-3, ensemble_of_lr=1e-3),
         "conv": dict(n=40, batch=16, epochs=1, lr=1e-2, of_lr=2e-3, ensemble_of_lr=0.2)}


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_train_nn_matches_jax_with_its_init_and_permutations(name):
    """``train_nn`` from JAX's init for seed 2, each epoch's permutation
    JAX's (``fold_in(shuffle_key, epoch)``), the last batch padded."""
    jarch, tarch = archs(name)
    cfg = TRAIN[name]
    x, y = data(cfg["n"], SHAPES[name], seed=2)
    ref = jax_train_nn(jarch, x, y, epochs=cfg["epochs"], lr=cfg["lr"], batch_size=cfg["batch"], seed=2,
                       verbose=False)
    init_key, shuffle_key = jax.random.split(jax.random.key(2))
    init = to_np(jarch.init(init_key))

    def perms(epoch):
        return torch.tensor(np.asarray(jax.random.permutation(jax.random.fold_in(shuffle_key, epoch), cfg["n"])))

    ours = train_nn(tarch, x, y, epochs=cfg["epochs"], lr=cfg["lr"], batch_size=cfg["batch"], verbose=False,
                    device="cpu", init=params_from_numpy(init), perms=perms, name="nn")
    for got, want, start in zip(tree_leaves(ours.params), jax.tree_util.tree_leaves(ref.params),
                                jax.tree_util.tree_leaves(init), strict=True):
        assert not got.requires_grad and not np.array_equal(np.asarray(want), start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=cfg["of_lr"] * cfg["lr"])
    assert ours.name == "nn" and len(ours.history["loss"]) == cfg["epochs"]
    assert all(0.0 <= a <= 100.0 for a in ours.history["accuracy"])
    assert abs(evaluate_nn(ours, x, y, verbose=False) - jax_evaluate_nn(ref, x, y, verbose=False)) <= 100.0 / cfg["n"]


def test_train_nn_logs_jax_losses_and_accuracies(capsys):
    """The epoch lines: the summed batch losses over N and the accuracy,
    from the same steps (fc2-16, seed 4, JAX's draws injected)."""
    jarch, tarch = archs("fc2")
    x, y = data(50, SHAPES["fc2"], seed=4)
    jax_train_nn(jarch, x, y, epochs=2, lr=1e-2, batch_size=16, seed=4)
    lines = [line for line in capsys.readouterr().out.split("\n") if line.startswith("[Epoch")]
    init_key, shuffle_key = jax.random.split(jax.random.key(4))
    ours = train_nn(tarch, x, y, epochs=2, lr=1e-2, batch_size=16, device="cpu",
                    init=params_from_numpy(to_np(jarch.init(init_key))),
                    perms=lambda e: torch.tensor(np.asarray(jax.random.permutation(jax.random.fold_in(shuffle_key, e),
                                                                                   50))))
    ours_lines = [line for line in capsys.readouterr().out.split("\n") if line.startswith("[Epoch")]
    assert len(lines) == len(ours_lines) == 2
    for line, mine in zip(lines, ours_lines):
        loss, acc = float(line.split()[3]), float(line.split()[5])
        np.testing.assert_allclose(float(mine.split()[3]), loss, rtol=1e-5)
        assert abs(float(mine.split()[5]) - acc) <= 100.0 / 50 + 1e-9


def jax_member_draws(jarch, ensemble_size, n, epochs):
    """JAX's member inits (``fold_in(key(i), 0)``) and per-epoch
    permutations (``fold_in(fold_in(key(i), 1), epoch)``), as JAX's
    ``train_ensemble`` makes them (``ensemble.py:218-232``)."""
    member_keys = jax.vmap(jax.random.key)(jnp.arange(ensemble_size, dtype=jnp.uint32))
    init = to_np(jax.vmap(jarch.init)(jax.vmap(lambda k: jax.random.fold_in(k, 0))(member_keys)))
    shuffle_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(member_keys)
    order = [np.asarray(jax.vmap(lambda k, e=e: jax.random.permutation(jax.random.fold_in(k, e), n))(shuffle_keys))
             for e in range(epochs)]
    return init, lambda i, epoch: torch.tensor(order[epoch][i])


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_train_ensemble_matches_jax_per_member(name):
    """Three members trained as one batched step, each from JAX's init and on
    JAX's shuffles: every member within the stated tolerance of JAX's, and
    the logged mean member loss within 1e-5 relative."""
    jarch, tarch = archs(name)
    cfg = TRAIN[name]
    x, y = data(cfg["n"], SHAPES[name], seed=5)
    ref = jax_train_ensemble(jarch, x, y, ensemble_size=3, epochs=cfg["epochs"], lr=cfg["lr"],
                             batch_size=cfg["batch"], verbose=False)
    init, perms = jax_member_draws(jarch, 3, cfg["n"], cfg["epochs"])
    ours = train_ensemble(tarch, x, y, ensemble_size=3, epochs=cfg["epochs"], lr=cfg["lr"], batch_size=cfg["batch"],
                          verbose=False, device="cpu", init=params_from_numpy(init), perms=perms)
    assert ours.ensemble_size == 3 and len(ours.history["loss"]) == 1
    diffs = []
    for got, want, start in zip(tree_leaves(ours.stacked_params), jax.tree_util.tree_leaves(ref.stacked_params),
                                jax.tree_util.tree_leaves(init), strict=True):
        assert got.shape[0] == 3 and not np.array_equal(np.asarray(want), start)
        diffs.append(np.abs(got.numpy() - np.asarray(want)).reshape(3, -1))
    for diff in np.concatenate(diffs, axis=1):  # one row per member
        assert diff.max() <= cfg["ensemble_of_lr"] * cfg["lr"], diff.max() / cfg["lr"]
        assert np.quantile(diff, 0.99) <= 2e-3 * cfg["lr"]
    assert not torch.equal(ours.stacked_params[0]["w"][0], ours.stacked_params[0]["w"][1])


def test_train_ensemble_logs_jax_mean_member_losses(capsys):
    jarch, tarch = archs("fc2")
    x, y = data(50, SHAPES["fc2"], seed=6)
    jax_train_ensemble(jarch, x, y, ensemble_size=3, epochs=2, lr=1e-2, batch_size=16)
    want = [float(line.split()[-1]) for line in capsys.readouterr().out.split("\n") if "mean member loss" in line]
    init, perms = jax_member_draws(jarch, 3, 50, 2)
    ours = train_ensemble(tarch, x, y, ensemble_size=3, epochs=2, lr=1e-2, batch_size=16, device="cpu",
                          init=params_from_numpy(init), perms=perms)
    out = capsys.readouterr().out
    assert out.count("[Ensemble epoch") == 2
    np.testing.assert_allclose(ours.history["loss"][0], want, rtol=1e-5)


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_member_chunk_changes_no_member(name):
    """Chunks of two members train the same numbers as one chunk of three
    (the port's own draws, seeds 0..2): bit-equal for fc2, within Adam's
    rounding for conv."""
    _, tarch = archs(name)
    cfg = TRAIN[name]
    x, y = data(cfg["n"], SHAPES[name], seed=7)
    kw = dict(ensemble_size=3, epochs=1, lr=cfg["lr"], batch_size=cfg["batch"], verbose=False, device="cpu")
    whole = train_ensemble(tarch, x, y, **kw)
    chunked = train_ensemble(tarch, x, y, member_chunk=2, **kw)
    assert len(chunked.history["loss"]) == 2
    for a, b in zip(tree_leaves(whole.stacked_params), tree_leaves(chunked.stacked_params), strict=True):
        if name == "fc2":
            assert torch.equal(a, b)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * cfg["lr"])


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_nn_and_ensemble_checkpoints_cross_packages(tmp_path, saved_by):
    """An NN's ``<name>/<name>_weights.npz`` and an ensemble's stacked
    ``<name>/weights/<name>_stacked.npz`` (meta ``ensemble_size``) written by
    one package load bit-equal in the other."""
    from robustbnns_tpu.utils.checkpoint import load_meta

    jarch, tarch = archs("fc2")
    rel = str(tmp_path)
    params, members = to_np(jarch.init(jax.random.key(8))), stacked_members(jarch, 3)
    jnn, jens = JaxNN(arch=jarch, params=params, name="nn"), JaxEnsemble(jarch, members, 3, name="ens")
    nn = DeterministicNN(tarch, params_from_numpy(params), name="nn")
    ens = EnsembleNN(tarch, params_from_numpy(members), 3, name="ens")
    writers = (nn, ens) if saved_by == "port" else (jnn, jens)
    nn_path = writers[0].save(rel, seed=1)
    ens_path = writers[1].save(rel)
    assert nn_path.endswith("nn/nn_weights_1.npz") and ens_path.endswith("ens/weights/ens_stacked.npz")
    assert load_meta(ens_path)["ensemble_size"] == 3
    got_nn = DeterministicNN(tarch, None, name="nn", device="cpu").load(rel, seed=1)
    got_ens = EnsembleNN(tarch, None, 3, name="ens", device="cpu").load(rel)
    ref_nn = JaxNN(arch=jarch, params=None, name="nn").load(rel, seed=1)
    ref_ens = JaxEnsemble(arch=jarch, stacked_params=None, ensemble_size=3, name="ens").load(rel)
    for tree, ref, want in ((got_nn.params, ref_nn.params, params), (got_ens.stacked_params, ref_ens.stacked_params,
                                                                     members)):
        for a, b, c in zip(tree_leaves(tree), jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(want),
                           strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
    with pytest.raises(ValueError, match="name"):
        DeterministicNN(tarch, params_from_numpy(params)).save(rel)


def test_mesh_raises_naming_the_parallelism_slice():
    """Named when ``mesh=`` raised; now the parallelism slice is ported: on a
    one-rank mesh (collectives run, nothing split) ``train_nn`` and
    ``train_ensemble`` train the unmeshed parameters and history bit for bit
    (``tests/test_torch_mesh_api.py`` holds two ranks)."""
    from torch_mesh_worker import one_rank_mesh

    _, tarch = archs("fc2")
    x, y = data(40, SHAPES["fc2"])
    kw = dict(epochs=2, lr=1e-2, batch_size=16, verbose=False, device="cpu")
    runs = {}
    for name, mesh in (("plain", None), ("mesh", "one rank")):
        with one_rank_mesh() if mesh else contextlib.nullcontext() as m:
            runs[name] = (train_nn(tarch, x, y, mesh=m, **kw),
                          train_ensemble(tarch, x, y, ensemble_size=2, mesh=m, **kw))
    for plain, meshed, leaves in zip(runs["plain"], runs["mesh"], ("params", "stacked_params")):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(getattr(plain, leaves)),
                                                     tree_leaves(getattr(meshed, leaves)), strict=True))
        assert plain.history["loss"] == meshed.history["loss"]
