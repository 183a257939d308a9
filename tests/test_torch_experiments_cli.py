"""The port's six experiment CLIs (``cli/grid_search_half_moons.py``,
``overparam.py``, ``baseline_attacks.py``, ``eps_attacks.py``,
``gradients_components.py``, ``multimodal.py``) end to end on the CPU at tiny
sizes: each ``main`` (``run``, then the figures) writes the JAX package's
file names, and ``run`` alone draws nothing.

The zoo gains tiny entries for the test (``model_99``: MNIST fc-16, its
ensemble of 3, an SVI BNN and an HMC multimodality config), trained through
the port's own training CLIs; the CLIs read them as they read the paper's.
"""
import os

import numpy as np
import pytest
import torch

from robustbnns_tpu.data import datasets as jax_datasets
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.cli import (
    baseline_attacks,
    eps_attacks,
    gradients_components,
    grid_search_half_moons,
    multimodal,
    overparam,
    train_bnn,
    train_ensemble,
    train_nn,
)
from robustbnns_tpu_torch.data import datasets

SVI = config.BNNConfig("mnist", 16, "leaky", "fc", "svi", epochs=1, lr=0.01)
TINY = ["--model_idx=99", "--device=cpu", "--savedir=DATA"]


@pytest.fixture
def workdir(monkeypatch, tmp_path):
    """A scratch working directory with the tiny zoo entries, the surrogate
    records emptied and restored (a served surrogate tags later saves)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", "data/")
    monkeypatch.setitem(config.saved_NNs, "model_99", config.NNConfig("mnist", 16, "leaky", "fc", 1, 0.01))
    monkeypatch.setitem(config.saved_BNNs, "model_99", SVI)
    monkeypatch.setitem(config.multimodal_BNNs, "model_99",
                        config.BNNConfig("mnist", 16, "leaky", "fc", "hmc", n_samples=5, warmup=5))
    for module in (datasets, jax_datasets):
        monkeypatch.setattr(module, "_surrogate_served", set())
        module._synthetic_image_dataset.cache_clear()
    yield tmp_path
    for module in (datasets, jax_datasets):
        module._synthetic_image_dataset.cache_clear()


def test_grid_and_overparam_clis(workdir):
    flags = ["--quick=True", "--device=cpu", "--savedir=DATA", "--test_points=12"]
    r = grid_search_half_moons.main(flags + ["--compute_attacks=True"])
    (bnn,) = r["trained"]
    name = bnn.name
    assert name == "half_moons_bnn_hmc_hid=32_act=leaky_arch=fc2_inp=200_samp=10_warm=10_stepsize=0.001_numsteps=10"
    for f in (f"{name}_weights.npz", f"{name}_samp=10_lossGrads.npz", f"{name}_fgsm_attackSamp=10_attack.npz"):
        assert os.path.exists(workdir / "data" / name / f), f
    assert r["grads"][0].shape == (12, 2) and r["attacks"][0].shape == (12, 1, 2, 1)
    # Another worker's share of the one-cell sweep is empty.
    assert grid_search_half_moons.run(flags + ["--host_id=1", "--n_hosts=2"])["cells"] == []
    with pytest.raises(ValueError, match="together"):
        grid_search_half_moons.run(flags + ["--host_id=1"])

    built = overparam.run(flags[:-1] + ["--test_points=12"])
    assert built["built"] and len(built["rows"]) == 12 and len(built["rows"][0]) == 15
    assert os.path.basename(built["csv"]) == "halfMoons_lossGrads_final_12.csv"
    assert not os.path.exists(workdir / "plots")
    read = overparam.main(flags[:-1] + ["--test_points=12"])
    assert not read["built"] and read["rows"] == built["rows"]
    assert read["plot"] == "plots/halfMoons_final_hmc_12.png" and os.path.exists(read["plot"])


def test_baseline_eps_and_gradients_clis(workdir):
    train_nn.main(TINY + ["--n_inputs=200", "--test=False"])
    train_ensemble.main(TINY + ["--n_inputs=200", "--ensemble_size=3", "--test=False"])
    train_bnn.main(TINY + ["--n_inputs=200", "--test=False"])

    r = baseline_attacks.main(TINY + ["--n_inputs=8", "--ensemble_size=3"])
    # The NN; the BNN at 1, 50 and 100 draws; the ensemble at 1 member (50 and 100 exceed its 3).
    assert len(r["rows"]) == 8 * (1 + 3 + 1)
    assert r["csv"].endswith("mnist_baseline_attacks_fgsm.csv") and os.path.exists(r["csv"])
    assert r["plot"] == "plots/mnist_baseline_attacks_fgsm_8.png" and os.path.exists(r["plot"])
    again = baseline_attacks.run(TINY + ["--n_inputs=8", "--ensemble_size=3", "--attack=False"])
    assert [row["softmax_rob"] for row in again["rows"]] == [row["softmax_rob"] for row in r["rows"]]

    r = eps_attacks.main(TINY + ["--n_inputs=4"])
    assert len(r["rows"]) == 4 * 5 * 3
    csv = workdir / "data" / SVI.name() / "mnist_increasing_eps_fgsm.csv"
    assert os.path.exists(csv) and r["plot"] == "plots/mnist_increasing_eps_fgsm.png"
    assert eps_attacks.run(TINY + ["--n_inputs=4", "--attack=False", "--test=False"])["rows"] == r["rows"]

    r = gradients_components.main(TINY + ["--n_inputs=6", "--compute_grads=True"])
    for s in gradients_components.STRIP_SAMPLES:
        assert os.path.exists(workdir / "data" / SVI.name() / f"{SVI.name()}_samp={s}_lossGrads.npz")
    for s, g in zip(gradients_components.HEATMAP_SAMPLES, r["heatmaps"]):
        assert g.shape == (6, 28, 28)
        assert np.array_equal(g, r["strip"][gradients_components.STRIP_SAMPLES.index(s)])
    assert r["strip_plot"] == f"plots/{SVI.name()}_gradComponents.png" and os.path.exists(r["strip_plot"])
    assert all(p.startswith("plots/vanishing_gradients_heatmaps/") for p in r["heatmap_plots"])


def test_multimodal_cli(workdir):
    r = multimodal.run(["--model_idx=99", "--debug=True", "--n_samples=5", "--device=cpu"])
    cfg_name = config.BNNConfig("mnist", 16, "leaky", "fc", "hmc", n_samples=5, warmup=5).name()
    assert r["csv"] == os.path.join("data", "debug", cfg_name, "mnist_fc_hmc_sepPCA.csv")
    assert os.path.exists(workdir / "data" / "debug" / cfg_name / "mnist_fc_hmc_trainInp=100.npz")
    assert len(r["rows"]) == 1000 + 5 and not os.path.exists(workdir / "plots")
    with open(r["csv"]) as f:
        assert f.readline() == ",n_samples,n_training_points,x,y\n"
    again = multimodal.main(["--model_idx=99", "--debug=True", "--n_samples=5", "--device=cpu",
                             "--plot_only=True"])
    assert again["rows"] == r["rows"] and "build_seconds" not in again
    assert again["plot"] == "plots/mnist_fc_hmc_sepPCA.png" and os.path.exists(again["plot"])


@pytest.mark.parametrize("cli", [grid_search_half_moons, overparam, baseline_attacks, eps_attacks,
                                 gradients_components, multimodal])
def test_experiment_clis_default_to_the_card(cli, monkeypatch):
    """No CLI carries on on the CPU without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.run([])


def test_port_imports_without_the_plotting_and_analysis_packages():
    """The card's machine has no matplotlib, seaborn or sklearn (and the port
    needs no pandas): every module of the port and ``chip_smoke.py`` imports
    with all four blocked, so only the figure functions need them."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((repo / "robustbnns_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    modules = [".".join(p.relative_to(repo).with_suffix("").parts).removesuffix(".__init__") for p in files]
    code = (
        "import importlib, sys\n"
        "for m in ('matplotlib', 'seaborn', 'pandas', 'sklearn'): sys.modules[m] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
