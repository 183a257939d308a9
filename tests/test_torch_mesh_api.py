"""The ``mesh=`` argument of every port API that has it in the JAX package,
case by case as ``tests/test_mesh_api.py``: ``svi_train``, ``train_nn``,
``train_ensemble``, ``BNN.train`` (SVI, HMC and NUTS), ``attack`` and
``attack_evaluation`` (FGSM, PGD, the fused twins, a ragged tail),
``batched_eval``, ``expected_loss_gradients`` and ``setup_device``'s mesh
specs.

Two gloo ranks (``tests/torch_mesh_worker.py``, a file store, no TCP port)
run every call under a 2x1 (``data``) or 1x2 (``sample``) mesh; each rank's
result is held to the same call without a mesh, run here, and the ranks'
parameters to each other by a SHA-256 gathered from every rank.

Tolerances: a sum over rows or draws split over two ranks rounds
differently, about 1e-7 of its scale. Forward values and input gradients are
held to 1e-6; trained parameters, after tens of Adam steps that divide by
the gradients' running RMS, to 1e-4 (the JAX test's 1e-4 for SVI); members
and chains that share nothing, and every split that moves no sum (FGSM, a
member range, a ragged tail), bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from robustbnns_tpu_torch.analysis.gradients import expected_loss_gradients
from robustbnns_tpu_torch.attacks import attack, attack_evaluation, load_attack
from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_train
from robustbnns_tpu_torch.models import DeterministicNN, build_architecture, train_ensemble, train_nn
from robustbnns_tpu_torch.predict import batched_eval
from robustbnns_tpu_torch.utils.pytree import tree_leaves

SHAPE, CLASSES, HIDDEN = worker.SHAPE, worker.CLASSES, worker.HIDDEN


@pytest.fixture(scope="module")
def inputs():
    x, y = worker.data(256)
    conv_x, conv_y = worker.data(32, seed=1, shape=(28, 28, 1))
    arch = build_architecture("fc2", "leaky", SHAPE, CLASSES, HIDDEN)
    loc = arch.init(torch.Generator().manual_seed(5))
    rho = tuple({k: torch.full_like(v, -3.0) for k, v in layer.items()} for layer in loc)
    return {"x": x, "y": y, "conv_x": conv_x, "conv_y": conv_y,
            **worker.tree_arrays("bnn_loc", loc), **worker.tree_arrays("bnn_rho", rho)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("api")
    return worker.spawn("api", 2, workdir, inputs), workdir


def bnn(inputs):
    model = worker.make_bnn("svi", **worker.SVI_CFG)
    model.posterior = MeanFieldPosterior(worker.tree_from(inputs, "bnn_loc"), worker.tree_from(inputs, "bnn_rho"))
    return model


def assert_close(got, want, atol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)


def test_svi_train_mesh_matches_single_device(inputs, ranks):
    arch = build_architecture("fc2", "leaky", SHAPE, CLASSES, 32)
    post, hist = svi_train(arch, inputs["x"], inputs["y"], seed=0, train_acc_samples=2, **worker.API_TRAIN)
    want = tree_leaves(post.loc) + tree_leaves(post.rho)
    for rank in ranks[0]:
        out = rank["svi_train"]
        assert len(set(out["checksums"])) == 1  # every rank holds the same posterior
        assert_close(out["leaves"], want, 1e-4)
        np.testing.assert_allclose(out["loss"], hist["loss"], rtol=1e-5)
        assert np.abs(np.subtract(out["accuracy"], hist["accuracy"])).max() <= 100.0 / 256  # a near-tie at most


def test_train_nn_mesh_matches_single_device(inputs, ranks):
    arch = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    model = train_nn(arch, inputs["x"], inputs["y"], seed=0, **worker.API_TRAIN)
    for rank in ranks[0]:
        out = rank["train_nn"]
        assert len(set(out["checksums"])) == 1
        assert_close(out["leaves"], tree_leaves(model.params), 1e-4)
        np.testing.assert_allclose(out["loss"], model.history["loss"], rtol=1e-5)


def test_train_ensemble_mesh_and_chunking_match(inputs, ranks):
    """Members split over ``sample`` share nothing: fc members are bit-equal to
    the unsharded ensemble, chunked or not, and where 3 members do not divide
    2 ranks (replicated). A conv ensemble's batched step sums its grouped
    convolutions in an order that depends on the member count, and Adam's
    steps are near ±lr whatever a gradient's scale, so one member a rank is
    held to the two-member step within 2e-3·lr, as ``tests/test_torch_nn.py``
    holds a conv NN (1.3e-3·lr seen)."""
    fc = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    kwargs = dict(ensemble_size=4, epochs=2, lr=0.01, batch_size=64, verbose=False, device="cpu")
    ref = train_ensemble(fc, inputs["x"], inputs["y"], **kwargs)
    odd = train_ensemble(fc, inputs["x"], inputs["y"], **{**kwargs, "ensemble_size": 3})
    conv = build_architecture("conv", "leaky", (28, 28, 1), CLASSES, 16, "mnist")
    conv_ref = train_ensemble(conv, inputs["conv_x"], inputs["conv_y"], ensemble_size=2, epochs=1, lr=0.01,
                              batch_size=16, verbose=False, device="cpu")
    for rank in ranks[0]:
        out = rank["train_ensemble"]
        assert len(set(out["checksums"])) == 1
        for name, want in (("fc", ref), ("fc_chunked", ref), ("fc_odd", odd)):
            assert all(torch.equal(a, b) for a, b in zip(out[name]["leaves"], tree_leaves(want.stacked_params),
                                                         strict=True)), name
        assert out["fc"]["loss"] == ref.history["loss"]
        assert_close(out["conv"]["leaves"], tree_leaves(conv_ref.stacked_params), 2e-3 * 0.01)


def test_bnn_train_svi_uses_default_mesh(inputs, ranks):
    ref = worker.make_bnn("svi", **worker.SVI_CFG).train(inputs["x"], inputs["y"], batch_size=64,
                                                         train_acc_samples=0, verbose=False)
    for rank in ranks[0]:
        out = rank["bnn_train"]
        assert out["restored"]  # use_mesh put the default back
        assert_close(out["svi"], tree_leaves(ref.posterior.loc) + tree_leaves(ref.posterior.rho), 1e-4)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_bnn_train_hmc_mesh_matches_single_device(inputs, ranks, sampler):
    """HMC and NUTS with each batch's rows over ``data``: U and ∇U are summed
    over the ranks at every evaluation, so the ranks take the same decisions
    (no rank waits at a collective another skipped) and hold the same draws.
    Against the unsharded chain, every decision of which is first checked to
    be clear of its threshold (``tests/test_torch_hmc.py``), the draws agree
    within 1e-5·max and the trees have the same evaluations. (With the
    warmup's adapted steps of near 1 these tiny chains are chaotic: a sum
    rounded two ways parts them within a few transitions, as JAX's mesh test
    says of its own.)"""
    from test_torch_hmc import assert_margins as hmc_margins
    from test_torch_nuts import assert_margins as nuts_margins

    from robustbnns_tpu_torch.inference import hmc

    trace, original = [], hmc.hmc_train_batched
    with pytest.MonkeyPatch.context() as mp:  # record the decisions of the unsharded run
        mp.setattr("robustbnns_tpu_torch.models.bnn.hmc_train_batched",
                   lambda *a, **kw: original(*a, trace=trace, **kw))
        ref = worker.make_bnn("hmc", **worker.SAMPLER_CFG[sampler]).train(
            inputs["x"], inputs["y"], batch_size=128, verbose=False, hmc_sampler=sampler)
    (hmc_margins if sampler == "hmc" else nuts_margins)(trace)
    want = tree_leaves(ref.samples)
    for rank in ranks[0]:
        out = rank["bnn_train"]
        assert len(set(out["checksums"])) == 1
        assert_close(out[sampler], want, 1e-5 * max(float(v.abs().max()) for v in want))
        assert out[f"{sampler}_history"]["evaluations"] == ref.history["evaluations"]


def test_attack_and_evaluation_mesh_match(inputs, ranks):
    """Each rank attacks its rows; the draws are the unsharded attack's (the
    generators step in lockstep; the fused twins' noise ignores the row), so
    FGSM and PGD move every pixel whose gradient is clear of zero as the
    unsharded attack does; the evaluation's counts and robustness agree, and
    the attack file is written once."""
    model = bnn(inputs)
    x, y = inputs["x"][:128], inputs["y"][:128]
    (rank0, rank1), workdir = ranks
    grads = _input_gradients(model.predictive_fn(3, seeds=[0, 1, 2]), torch.tensor(x),
                             torch.tensor(y).argmax(-1), None)
    assert float((grads.abs() > 1e-6 * float(grads.abs().max())).float().mean()) > 0.9
    for method, fused in (("fgsm", False), ("pgd", False), ("fgsm", True)):
        name = f"{method}_fused" if fused else method
        want = attack(model, x, y, method=method, n_samples=3, fused=fused, batch_size=64, save=False,
                      verbose=False)
        for rank in (rank0, rank1):
            np.testing.assert_allclose(rank["attacks"][name].numpy(), want.numpy(), atol=1e-6)
        assert torch.equal(rank0["attacks"][name], rank1["attacks"][name])
    clean, adv, rob = attack_evaluation(model, x, rank0["attacks"]["fgsm"], y, n_samples=3, batch_size=64,
                                        verbose=False)
    for rank in (rank0, rank1):
        got = rank["attacks"]["evaluation"]
        assert got[:2] == (clean, adv)
        np.testing.assert_allclose(got[2].numpy(), rob.numpy(), atol=1e-6)
    path = os.path.join(workdir, "files", "mesh_attack", "mesh_attack_fgsm_attackSamp=3_attack.npz")
    saved = load_attack(method="fgsm", filename="mesh_attack", n_samples=3, rel_path=os.path.join(workdir, "files"))
    assert os.path.exists(path) and torch.equal(saved, rank0["attacks"]["fgsm_file"])


def test_attack_mesh_handles_ragged_tail(inputs, ranks):
    """69 rows in batches of 64: the 5-row tail does not divide 2 ranks and runs
    whole on both, drawing in lockstep: the attack equals the unsharded one."""
    want = attack(bnn(inputs), inputs["x"][:69], inputs["y"][:69], method="fgsm", n_samples=2, batch_size=64,
                  save=False, verbose=False)
    for rank in ranks[0]:
        np.testing.assert_allclose(rank["attacks"]["ragged"].numpy(), want.numpy(), atol=1e-6)
        assert torch.equal(rank["attacks"]["ragged"][64:], want[64:])


def test_expected_loss_gradients_mesh_matches(inputs, ranks):
    """The S draws over ``sample`` (4 draws, and 3 split 1 + 2), the rows over
    ``data``, and the deterministic branch's rows."""
    model = bnn(inputs)
    x, y = inputs["x"][:64], inputs["y"][:64]
    want = {n: expected_loss_gradients(model, x, y, n_samples=n, batch_size=32) for n in (3, 4)}
    nn = DeterministicNN(build_architecture("fc2", "leaky", SHAPE, CLASSES, HIDDEN),
                         worker.tree_from(inputs, "bnn_loc"))
    det = expected_loss_gradients(nn, x, y, n_samples=None, batch_size=32)
    for rank in ranks[0]:
        out = rank["gradients"]
        for name, ref in (("2x1", want[4]), ("1x2", want[4]), ("odd_draws", want[3]), ("deterministic", det)):
            np.testing.assert_allclose(out[name].numpy(), ref.numpy(), atol=1e-6 * float(ref.abs().max()),
                                       err_msg=name)


def test_batched_eval_mesh_matches(inputs, ranks):
    fn = bnn(inputs).predictive_fn(n_samples=3, seeds=[0, 1, 2])
    outs, correct = batched_eval(fn, torch.tensor(inputs["x"][:100]), torch.tensor(inputs["y"][:100]),
                                 batch_size=32)
    for rank in ranks[0]:
        got_outs, got_correct = rank["batched_eval"]
        assert got_outs.shape == (100, CLASSES) and float(got_correct) == float(correct)
        np.testing.assert_allclose(got_outs.numpy(), outs.numpy(), atol=1e-6)


def test_setup_device_parses_mesh_specs(ranks):
    """``--mesh`` specs and ``ROBUSTBNNS_MESH`` as the JAX package parses them."""
    for rank in ranks[0]:
        assert rank["setup_device"] == [
            ("cpu", {"data": 2, "sample": 1}), ("cpu", {"data": 1, "sample": 2}), ("cpu", {"data": 2, "sample": 1}),
            ("cpu", {"data": 2, "sample": 1}), ("env", {"data": 1, "sample": 2}),
        ]
