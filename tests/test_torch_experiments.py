"""The port's experiments (``experiments/*``) against the JAX package's, on the
CPU, on tiny models that JAX trained and saved and the port loads.

Tolerances:

* the grid's expected gradients, on the same HMC posterior: 1e-5 relative
  (the same f32 products in another order); the overparam rows: the same
  gradients, ``test_acc`` equal, the points exact;
* the baseline and ε-sweep rows on an NN, a 3-member ensemble and an SVI BNN
  whose ``rho`` is -30 (softplus 9.4e-14, so a fresh draw rounds to the
  mean and both packages' draws coincide): ``softmax_rob`` within 1e-5,
  ``test_acc``/``adv_acc`` and every other column equal;
* the CSVs interchange: each package's reader takes the other's file and
  gives its own rows (floats within 1e-6 relative: pandas writes float32
  columns in float32's shortest form, the port each value's float64 form);
* ``flat_posterior`` bit-equal; the PCA against sklearn's full SVD within
  1e-5 of the largest coordinate, signs included; the multimodal rows on
  JAX's Half Moons fc-16 chains within 1e-4 of the largest coordinate
  (sklearn's "auto" picks the covariance solver in float32 for the prior).
"""
import dataclasses
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from robustbnns_tpu.analysis import load_loss_gradients as jax_load_loss_gradients
from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.data import load_dataset as jax_load_dataset
from robustbnns_tpu.experiments import baseline as jax_baseline
from robustbnns_tpu.experiments import eps as jax_eps
from robustbnns_tpu.experiments import grid_search as jax_grid
from robustbnns_tpu.experiments import multimodal as jax_multimodal
from robustbnns_tpu.experiments import overparam as jax_overparam
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.models import train_ensemble as jax_train_ensemble
from robustbnns_tpu.models import train_nn as jax_train_nn
from robustbnns_tpu_torch.config import BNNConfig
from robustbnns_tpu_torch.data.datasets import load_dataset
from robustbnns_tpu_torch.experiments import baseline, eps, grid_search, multimodal, overparam
from robustbnns_tpu_torch.models import BNN, DeterministicNN, EnsembleNN, build_architecture

QUICK = dict(hidden_size=[32], activation=["leaky"], architecture=["fc2"], inference=["hmc"], epochs=[None],
             lr=[None], n_samples=[10], warmup=[10], n_inputs=[200])
TEST_POINTS, GRAD_SAMPLES = 20, [10]


def close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def assert_rows_match(ours, ref, float_cols=(), rtol=1e-5):
    """Same columns in the same order, same row count; ``float_cols`` within
    ``rtol`` relative, the rest equal (``None`` for pandas' NaN)."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in a:
            rb = None if isinstance(b[k], float) and np.isnan(b[k]) else b[k]
            if k in float_cols:
                assert close(a[k], rb, rtol), (k, a[k], rb)
            else:
                assert a[k] == rb, (k, a[k], rb)


# --------------------------------------------------------------------------- #
# Grid search and overparametrization
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_grid_cell(tmp_path_factory):
    """JAX's quick cell trained, its gradients and overparam rows; the
    checkpoints copied to a directory of the port's."""
    root = tmp_path_factory.mktemp("grid")
    jax_rel, port_rel = str(root / "jax") + "/", str(root / "port") + "/"
    cells = jax_grid.grid_combinations(**QUICK)
    (bnn,) = jax_grid.grid_train(cells, jax_rel, verbose=False)
    shutil.copytree(jax_rel, port_rel)
    jax_grid.grid_compute_grads(cells, GRAD_SAMPLES, TEST_POINTS, jax_rel, verbose=False)
    df = jax_overparam.build_overparam_scatterplot_dataset(cells, GRAD_SAMPLES, TEST_POINTS, rel_path=jax_rel,
                                                           out_dir=jax_rel, verbose=False)
    return dict(cells=cells, bnn=bnn, jax_rel=jax_rel, port_rel=port_rel, df=df)


def test_grid_axes_config_and_batch_sizes_are_jaxs():
    from robustbnns_tpu_torch.cli.grid_search_half_moons import REFERENCE_SWEEP

    assert grid_search.grid_combinations(**REFERENCE_SWEEP) == jax_grid.grid_combinations(**REFERENCE_SWEEP)
    assert len(grid_search.grid_combinations(**REFERENCE_SWEEP)) == 36
    args = (512, "leaky", "fc2", "hmc", None, None, 250, 100)
    assert dataclasses.asdict(grid_search.moons_config(*args)) == dataclasses.asdict(jax_grid.moons_config(*args))
    for inference in ("svi", "hmc"):
        assert grid_search.moons_batch_size(inference) == jax_grid.moons_batch_size(inference)
    cells = grid_search.grid_combinations(**REFERENCE_SWEEP)
    for h, n in ((0, 1), (27, 36), (2, 7)):
        assert grid_search.grid_cells_for_host(cells, h, n) == jax_grid.grid_cells_for_host(cells, h, n)


def test_grid_train_names_resume_save_and_sampler(jax_grid_cell, tmp_path, monkeypatch):
    cells = jax_grid_cell["cells"]
    rel = str(tmp_path / "port") + "/"
    (bnn,) = grid_search.grid_train(cells, rel, verbose=False, device="cpu")
    assert bnn.name == jax_grid_cell["bnn"].name
    assert bnn.name.endswith("_inp=200_samp=10_warm=10_stepsize=0.001_numsteps=10")
    assert os.path.exists(os.path.join(rel, bnn.name, bnn.name + "_weights.npz"))

    def no_training(*args, **kwargs):
        raise AssertionError("a cell with a checkpoint was trained again")

    monkeypatch.setattr(BNN, "train", no_training)
    (resumed,) = grid_search.grid_train(cells, rel, verbose=False, device="cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(resumed.samples, bnn.samples))
    monkeypatch.undo()
    (unsaved,) = grid_search.grid_train(cells, str(tmp_path / "none") + "/", save=False, verbose=False, device="cpu")
    assert unsaved.samples is not None and not os.path.exists(tmp_path / "none")
    with pytest.raises(ValueError, match="unknown sampler"):
        grid_search.grid_train(cells, str(tmp_path / "bad") + "/", sampler="gibbs", verbose=False, device="cpu")


def test_grid_gradients_and_overparam_rows_are_jaxs(jax_grid_cell):
    cells, jax_rel, port_rel = jax_grid_cell["cells"], jax_grid_cell["jax_rel"], jax_grid_cell["port_rel"]
    (grads,) = grid_search.grid_compute_grads(cells, GRAD_SAMPLES, TEST_POINTS, port_rel, verbose=False,
                                              device="cpu")
    name = jax_grid_cell["bnn"].name
    ref = jax_load_loss_gradients(GRAD_SAMPLES[0], name, name, jax_rel)
    assert grads.shape == ref.shape == (TEST_POINTS, 2)
    np.testing.assert_allclose(grads, ref, rtol=1e-5, atol=0)
    rows = overparam.build_overparam_scatterplot_dataset(cells, GRAD_SAMPLES, TEST_POINTS, rel_path=port_rel,
                                                         out_dir=port_rel, verbose=False, device="cpu")
    assert len(rows) == TEST_POINTS and len(rows[0]) == 15
    assert_rows_match(rows, jax_grid_cell["df"].to_dict("records"), ("loss_gradients_x", "loss_gradients_y"))
    # The CSVs interchange: pandas reads the port's file as it reads JAX's, and the reverse.
    ours = overparam.overparam_csv_path(TEST_POINTS, port_rel)
    theirs = os.path.join(jax_rel, f"halfMoons_lossGrads_final_{TEST_POINTS}.csv")
    pd.testing.assert_frame_equal(pd.read_csv(ours), pd.read_csv(theirs), rtol=1e-5)
    assert_rows_match(overparam.load_overparam_scatterplot_dataset(TEST_POINTS, jax_rel), rows,
                      ("x", "y", "loss_gradients_x", "loss_gradients_y"))


# --------------------------------------------------------------------------- #
# Baseline and ε sweep
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def three_models(tmp_path_factory):
    """An fc2-16 NN, a 3-member ensemble and an SVI BNN with rho = -30 trained
    and saved by JAX on Half Moons, and the port's copies loaded from disk."""
    import jax.numpy as jnp
    from jax.tree_util import tree_map

    rel = str(tmp_path_factory.mktemp("models")) + "/"
    x_train, y_train, x_test, y_test, shape, out = jax_load_dataset("half_moons", n_inputs=400)
    arch = jax_build("fc2", "leaky", shape, out, 16)
    jax_nn = jax_train_nn(arch, x_train, y_train, epochs=3, lr=0.01, name="unit_nn", verbose=False)
    jax_nn.save(rel)
    jax_train_ensemble(arch, x_train, y_train, ensemble_size=3, epochs=2, lr=0.01, name="unit_ens",
                       verbose=False).save(rel)
    cfg = JaxBNNConfig("half_moons", 16, "leaky", "fc2", "svi", epochs=3, lr=0.01)
    trained = JaxBNN.from_config(cfg, shape, out).train(x_train, y_train, batch_size=64, train_acc_samples=0,
                                                        verbose=False)
    trained.posterior = trained.posterior._replace(rho=tree_map(lambda r: jnp.full_like(r, -30.0),
                                                                trained.posterior.rho))
    trained.save(rel)
    from robustbnns_tpu.models import DeterministicNN as JaxNN
    from robustbnns_tpu.models import EnsembleNN as JaxEnsemble

    jax_models = (JaxNN(arch=arch, params=None, name="unit_nn").load(rel),
                  JaxBNN.from_config(cfg, shape, out).load(rel),
                  JaxEnsemble(arch=arch, stacked_params=None, ensemble_size=3, name="unit_ens").load(rel))
    parch = build_architecture("fc2", "leaky", shape, out, 16)
    port_models = (DeterministicNN(arch=parch, params=None, name="unit_nn", device="cpu").load(rel),
                   BNN.from_config(BNNConfig(**dataclasses.asdict(cfg)), shape, out, device="cpu").load(rel),
                   EnsembleNN(arch=parch, stacked_params=None, ensemble_size=3, name="unit_ens",
                              device="cpu").load(rel))
    return jax_models, port_models, x_test[:32], y_test[:32]


def test_baseline_rows_and_csv_are_jaxs(three_models, tmp_path):
    jax_models, port_models, x, y = three_models
    kwargs = dict(bayesian_attack_samples=(1,), bayesian_defence_samples=(1, 3), ensemble_samples=(1, 3),
                  verbose=False)
    ref = jax_baseline.build_baseline_attacks_df(*jax_models, x, y, rel_path=str(tmp_path / "jax") + "/", **kwargs)
    rows = baseline.build_baseline_attacks_df(*port_models, x, y, rel_path=str(tmp_path / "port") + "/", **kwargs)
    assert len(rows) == 32 * 5
    assert [r["model_type"] for r in rows[::32]] == ["nn", "bnn", "bnn", "ensemble", "ensemble"]
    assert_rows_match(rows, ref.to_dict("records"), ("softmax_rob",))
    # The attacks were saved under JAX's names.
    for name in ("unit_nn/unit_nn_fgsm_attack.npz", "unit_ens/unit_ens_fgsm_attackSamp=3_attack.npz"):
        assert os.path.exists(tmp_path / "port" / name)

    ours = baseline.save_baseline_attacks_df(rows, "half_moons", "fgsm", str(tmp_path / "p"))
    theirs = jax_baseline.save_baseline_attacks_df(ref, "half_moons", "fgsm", str(tmp_path / "j"))
    assert os.path.basename(ours) == os.path.basename(theirs) == "half_moons_baseline_attacks_fgsm.csv"
    pd.testing.assert_frame_equal(jax_baseline.load_baseline_attacks_df("half_moons", "fgsm", str(tmp_path / "p")),
                                  ref, rtol=1e-5)
    assert_rows_match(baseline.load_baseline_attacks_df("half_moons", "fgsm", str(tmp_path / "j")), rows,
                      ("softmax_rob",))


def test_eps_rows_and_csv_are_jaxs(three_models, tmp_path):
    jax_models, port_models, x, y = three_models
    kwargs = dict(dataset="half_moons", method="fgsm", epsilon_list=(0.1, 0.3), n_samples_list=(1, 3),
                  savedir="unit", verbose=False)
    ref = jax_eps.build_eps_attacks_df(jax_models[1], x, y, out_dir=str(tmp_path / "j"), **kwargs)
    rows = eps.build_eps_attacks_df(port_models[1], x, y, out_dir=str(tmp_path / "p"), **kwargs)
    assert len(rows) == 32 * 4
    assert_rows_match(rows, ref.to_dict("records"), ("softmax_rob",))
    pd.testing.assert_frame_equal(jax_eps.load_eps_attacks_df("half_moons", "fgsm", "unit", str(tmp_path / "p")),
                                  ref, rtol=1e-5)
    assert_rows_match(eps.load_eps_attacks_df("half_moons", "fgsm", "unit", str(tmp_path / "j")), rows,
                      ("softmax_rob",))


# --------------------------------------------------------------------------- #
# Multimodality
# --------------------------------------------------------------------------- #


def test_flat_posterior_is_jaxs(jax_grid_cell):
    bnn = jax_grid_cell["bnn"]
    *cfg_args, n_inputs = jax_grid_cell["cells"][0]
    ours = BNN.from_config(grid_search.moons_config(*cfg_args), (1, 2, 1), 2, n_inputs=n_inputs,
                           device="cpu").load(rel_path=jax_grid_cell["jax_rel"])
    flat = multimodal.flat_posterior(ours).numpy()
    ref = jax_multimodal.flat_posterior(bnn)
    assert flat.shape == ref.shape and flat.tobytes() == ref.tobytes()


@pytest.mark.parametrize("shape", [(40, 300), (300, 40)])
def test_pca_is_sklearns_full_svd(shape):
    """The Gram path (n ≤ D) and the scatter path (n > D), fitted and
    applied to the same rows and to other rows."""
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(4)
    a = (rng.standard_normal(shape) * np.linspace(3, 1, shape[1])).astype(np.float32)
    b = rng.standard_normal((25, shape[1])).astype(np.float32)
    ref = PCA(n_components=2, svd_solver="full").fit(a.astype(np.float64))
    pairs = [(multimodal.pca_fit_transform(torch.from_numpy(a)), ref.transform(a.astype(np.float64))),
             (multimodal.pca_transform(torch.from_numpy(b), *multimodal.pca_fit(torch.from_numpy(a))),
              ref.transform(b.astype(np.float64)))]
    for ours, want in pairs:
        assert ours.dtype == torch.float32 and ours.shape == want.shape
        np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("same_pca", [False, True])
def test_multimodal_rows_on_jaxs_chains(same_pca, tmp_path_factory):
    rel = str(tmp_path_factory.getbasetemp() / "multimodal") + "/"
    cfg = JaxBNNConfig("half_moons", 16, "leaky", "fc", "hmc", n_samples=6, warmup=10, step_size=0.01)
    kwargs = dict(n_samples=6, rel_path=rel, evaluate=False, verbose=False, same_pca=same_pca)
    trained = os.path.exists(os.path.join(rel, cfg.name()))
    ref = jax_multimodal.build_multimodal_df(cfg, [50, 100], train=not trained, **kwargs)
    rows = multimodal.build_multimodal_df(BNNConfig(**dataclasses.asdict(cfg)), [50, 100], train=False,
                                          device="cpu", **kwargs)
    assert len(rows) == 1000 + 2 * 6
    ref_rows = ref.to_dict("records")
    for key in ("n_samples", "n_training_points"):
        assert [r[key] for r in rows] == [r[key] for r in ref_rows]
    xy = np.array([[r["x"], r["y"]] for r in rows])
    want = np.array([[r["x"], r["y"]] for r in ref_rows], dtype=np.float64)
    np.testing.assert_allclose(xy, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # index_col=0 both ways, as the CLI writes and reads them
    from robustbnns_tpu_torch.experiments.tables import read_rows, write_rows

    ours_csv, theirs_csv = os.path.join(rel, "port.csv"), os.path.join(rel, "jax.csv")
    write_rows(ours_csv, rows, index=True)
    ref.to_csv(theirs_csv)
    pd.testing.assert_frame_equal(pd.read_csv(ours_csv, index_col=0), pd.read_csv(theirs_csv, index_col=0),
                                  rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert_rows_match(read_rows(theirs_csv, index_col=0), [dict(r) for r in ref_rows], ("x", "y"), rtol=1e-6)
