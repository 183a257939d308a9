"""The port's slices as a whole: SVI training of an fc2 posterior and Bayesian
FGSM/PGD on it.

* the port imports neither JAX nor the JAX package;
* a posterior saved by the port drives both packages' attack flows, which must
  agree at zero posterior scale (where every draw is the mean, so the noise
  streams do not matter) up to bounded sign flips of f32-level gradients;
* the attack CLI runs end to end on the CPU at ``model_7``'s full width, on a
  saved posterior and after training one, and attacks with ``--attack=False``
  as JAX's BNN branch does; the training CLI trains, saves, evaluates and loads;
* ``resolve_device`` alone turns TF32 off;
* NNs and ensembles: FGSM and PGD on the same parameters move the pixels
  JAX's attacks move (deterministic models: no draws to replay), and the NN
  and ensemble CLIs train, save, load, attack and reload an attack on the
  CPU at tiny sizes.
"""
import ast
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from robustbnns_tpu.attacks import attack as jax_attack
from robustbnns_tpu.attacks import attack_evaluation as jax_attack_evaluation
from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.attacks import attack, attack_evaluation
from robustbnns_tpu_torch.cli import attacks as cli
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.utils.pytree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "robustbnns_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_determinism_cost.py"]


def test_port_never_imports_jax():
    """Importing every module of the port (and chip_smoke and the
    determinism script) leaves JAX out."""
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'robustbnns_tpu.'))"
        " or m == 'robustbnns_tpu']\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "robustbnns_tpu"), f"{path}: imports {name}"


CFG = config.BNNConfig("mnist", 32, "leaky", "fc2", "svi", epochs=1, lr=0.01)


@pytest.fixture(scope="module")
def saved_posterior(tmp_path_factory):
    """A zero-scale fc2-32 posterior for 28x28 MNIST, saved by the port."""
    rel = str(tmp_path_factory.mktemp("ckpt"))
    bnn = BNN.from_config(CFG, (28, 28, 1), 10, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(0))
    rho = tuple({k: torch.full_like(v, -30.0) for k, v in layer.items()} for layer in loc)
    bnn.posterior = MeanFieldPosterior(loc, rho)
    bnn.save(rel_path=rel)
    return rel


@pytest.mark.parametrize("method", ["fgsm", "pgd"])
def test_attack_flow_matches_jax_at_zero_scale(saved_posterior, method):
    """Load the port's checkpoint into both packages, attack and evaluate.

    The JAX side runs FGSM through its fused Pallas predictive (interpret mode)
    and PGD through its unfused one (40 interpret-mode steps would take
    minutes); the port runs both fused.
    """
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(16, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]

    ours = BNN.from_config(CFG, (28, 28, 1), 10, device="cpu").load(rel_path=saved_posterior)
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(CFG)), (28, 28, 1), 10)
    ref.load(rel_path=saved_posterior)

    xa = attack(ours, x, y, method=method, n_samples=4, fused=True, batch_size=8, verbose=False)
    xa_ref = jax_attack(ref, x, y, method=method, n_samples=4, fused=method == "fgsm",
                        batch_size=8, key=jax.random.key(0), save=False, verbose=False)
    assert (np.abs(xa.numpy() - np.asarray(xa_ref)) > 1e-6).mean() <= 0.02

    clean, adv, rob = attack_evaluation(ours, x, xa, y, n_samples=4, verbose=False)
    clean_ref, adv_ref, rob_ref = jax_attack_evaluation(ref, x, xa.numpy(), y, n_samples=4, verbose=False)
    assert clean == clean_ref and adv == adv_ref
    np.testing.assert_allclose(rob.numpy(), np.asarray(rob_ref), atol=1e-5)
    assert adv <= clean


def test_cli_runs_model_7_on_the_cpu(monkeypatch, tmp_path):
    """The attack CLI at model_7's full width (fc2-1024), fused, on 8 images."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    bnn = BNN.from_config(config.saved_BNNs["model_7"], (28, 28, 1), 10, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(7))
    rho = tuple({k: torch.full_like(v, -6.0) for k, v in layer.items()} for layer in loc)
    bnn.posterior = MeanFieldPosterior(loc, rho)
    bnn.save(rel_path=config.DATA)

    out = cli.main(["--model_type=bnn", "--model_idx=7", "--fused=True", "--train=False",
                    "--test=False", "--n_inputs=8", "--device=cpu", "--attack_method=fgsm"])
    x, xa = torch.as_tensor(out["x_test"]), out["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and bool(torch.isfinite(xa).all())
    assert float((xa - x).abs().max()) <= 0.3 + 1e-6
    assert float(((xa - x).abs() > 0).float().mean()) > 0.2
    assert 0.0 <= out["adversarial_accuracy"] <= 100.0
    assert os.path.exists(tmp_path / "data" / bnn.name / f"{bnn.name}_fgsm_attackSamp=10_attack.npz")


@pytest.fixture
def cli_workdir(monkeypatch, tmp_path):
    """Checkpoints, figures and the surrogate cache under ``tmp_path``, with
    fresh records of the datasets served synthetically."""
    from robustbnns_tpu_torch.data import datasets

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    monkeypatch.setattr(datasets, "_surrogate_served", set())
    datasets._synthetic_image_dataset.cache_clear()
    return tmp_path


def test_train_cli_trains_and_evaluates_model_7_on_the_cpu(cli_workdir, monkeypatch):
    """``cli/train_bnn`` trains model_7 at full width for its 5 epochs on 200
    surrogate images, saves the posterior and the training curves, evaluates,
    and loads the checkpoint back with ``--train=False``; with the HMC flags
    it trains the same SVI posterior, and on an HMC model ``--hmc_sampler=nuts``
    samples by NUTS (model_3 cut to one draw, no warmup and a step of 1e3,
    so that every draw diverges at its first leaf: two evaluations a draw at
    fc2-1024 widths) and saves the draws under the HMC leaf names."""
    from robustbnns_tpu_torch.cli import train_bnn

    flags = ["--model_idx=7", "--n_inputs=200", "--savedir=DATA", "--device=cpu"]
    bnn = train_bnn.main(flags + ["--train=True", "--test=True"])
    loss = bnn.history["loss"]
    assert len(loss) == 5 and all(np.isfinite(loss)) and loss[-1] < loss[0]
    folder = cli_workdir / "data" / bnn.name
    assert (folder / f"{bnn.name}_weights.npz").exists() and (folder / f"{bnn.name}_training.png").exists()
    leaves = [v for tree in bnn.posterior for layer in tree for v in layer.values()]
    assert not any(v.requires_grad for v in leaves)
    loaded = train_bnn.main(flags + ["--train=False", "--test=False"])
    for tree, other in zip(bnn.posterior, loaded.posterior):
        for layer, layer2 in zip(tree, other):
            assert all(torch.equal(layer[k], layer2[k]) for k in layer)
    # An SVI model ignores the HMC flags, as JAX's does: the same posterior.
    flagged = train_bnn.main(flags + ["--train=True", "--test=False", "--hmc_sampler=nuts", "--hmc_mode=full",
                                      "--hmc_init=map", "--num_chains=2"])
    for tree, other in zip(bnn.posterior, flagged.posterior):
        for layer, layer2 in zip(tree, other):
            assert all(torch.equal(layer[k], layer2[k]) for k in layer)
    # NUTS on an HMC model (model_3), cut to a run of two diverging draws.
    from robustbnns_tpu_torch.inference.nuts import NUTSInfo

    cut = dataclasses.replace(config.saved_BNNs["model_3"], n_samples=1, warmup=0, step_size=1e3)
    monkeypatch.setitem(config.saved_BNNs, "model_3", cut)
    hmc_flags = ["--model_idx=3", "--n_inputs=200", "--savedir=DATA", "--device=cpu", "--test=False"]
    nuts_bnn = train_bnn.main(hmc_flags + ["--hmc_sampler=nuts"])
    info = nuts_bnn.hmc_info
    assert isinstance(info, NUTSInfo) and info.num_leapfrog.tolist() == [1, 1] and bool(info.diverging.all())
    assert nuts_bnn.history["evaluations"] == [4] and nuts_bnn.samples[0]["w"].shape == (1, 784, 1024)
    reloaded = train_bnn.main(hmc_flags + ["--train=False"])
    assert all(torch.equal(reloaded.samples[i][k], nuts_bnn.samples[i][k]) for i in range(3) for k in ("b", "w"))


def test_attack_cli_trains_then_attacks_on_the_cpu(cli_workdir, monkeypatch):
    """``--train=True``: model_7 at full width trains for its 5 epochs (on the
    first 256 surrogate training images: the CLI takes the whole set), then
    FGSM attacks the trained posterior through the fused ops, whose backward
    asks for no parameter gradient (PGD would regenerate the twins' noise
    for 40 steps at this width; ``chip_smoke.py`` runs PGD on the card)."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    load = cli.load_data
    monkeypatch.setattr(cli, "load_data", lambda ds, n, shuffle=True: load(ds, 256, shuffle))
    calls = []
    twin = sd.sampled_dense_xs_dparams_plain
    monkeypatch.setattr(sd, "sampled_dense_xs_dparams_plain", lambda *a: calls.append(1) or twin(*a))
    out = cli.main(["--model_type=bnn", "--model_idx=7", "--train=True", "--fused=True",
                    "--test=False", "--n_inputs=8", "--device=cpu", "--attack_method=fgsm"])
    bnn = out["bnn"]
    assert len(bnn.history["loss"]) == 5 and np.isfinite(bnn.history["loss"]).all()
    assert out["train_images"] == 256 and out["train_seconds"] > 0
    x, xa = torch.as_tensor(out["x_test"]), out["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and bool(torch.isfinite(xa).all())
    assert float((xa - x).abs().max()) <= 0.3 + 1e-6 and 0 <= float(xa.min()) and float(xa.max()) <= 1
    assert not calls
    assert os.path.exists(cli_workdir / "data" / bnn.name / f"{bnn.name}_weights.npz")


@pytest.mark.parametrize(
    "flags,error",
    [
        (["--model_type=gp", "--device=cpu"], NotImplementedError),
    ],
)
def test_cli_refuses_what_is_not_ported(flags, error):
    with pytest.raises(error):
        cli.main(flags)


def test_cli_bf16_switches_products_for_the_run(monkeypatch):
    """``--bf16=True`` runs the branch with the bf16 switch thrown, so every
    dense and conv product takes bf16 operands (JAX ``cli/attacks.py:61-68``
    sets ROBUSTBNNS_BF16=1 for that), and only for that run; the environment
    is left as it was."""
    from robustbnns_tpu_torch.utils.device import bf16_products

    seen = []
    monkeypatch.delenv("ROBUSTBNNS_BF16", raising=False)
    monkeypatch.setattr(cli, "_bnn_branch", lambda args, device, rel: seen.append(
        (bf16_products(), args.fused)) or {})
    cli.main(["--model_type=bnn", "--bf16=True", "--device=cpu"])
    cli.main(["--model_type=bnn", "--device=cpu"])
    assert seen == [(True, False), (False, False)]
    assert not bf16_products() and "ROBUSTBNNS_BF16" not in os.environ
    monkeypatch.setenv("ROBUSTBNNS_BF16", "0")
    cli.main(["--model_type=bnn", "--bf16=True", "--device=cpu"])
    assert seen[-1] == (True, False) and os.environ["ROBUSTBNNS_BF16"] == "0" and not bf16_products()


def test_cli_mesh_auto_attacks_on_one_rank(cli_workdir, capsys):
    """``--mesh=auto --device=cpu`` in one process: a one-rank gloo group and a
    1x1 default mesh, through which the attack and its evaluation run their
    collectives; the attack equals the unmeshed CLI's bit for bit, and rank 0
    writes its file."""
    import torch.distributed as dist

    from robustbnns_tpu_torch.parallel import get_default_mesh, set_default_mesh

    bnn = BNN.from_config(config.saved_BNNs["model_7"], (28, 28, 1), 10, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(7))
    bnn.posterior = MeanFieldPosterior(loc, tuple({k: torch.full_like(v, -6.0) for k, v in p.items()} for p in loc))
    bnn.save(rel_path=config.DATA)
    flags = ["--model_type=bnn", "--model_idx=7", "--train=False", "--test=False", "--n_inputs=8", "--device=cpu",
             "--attack_method=fgsm"]
    plain = cli.main(flags)
    try:
        meshed = cli.main(flags + ["--mesh=auto"])
        assert get_default_mesh().shape == {"data": 1, "sample": 1}
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        set_default_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "[mesh] default mesh installed: {'data': 1, 'sample': 1}" in capsys.readouterr().out
    assert torch.equal(meshed["x_attack"], plain["x_attack"])
    assert (meshed["clean_accuracy"], meshed["adversarial_accuracy"]) == (plain["clean_accuracy"],
                                                                          plain["adversarial_accuracy"])
    assert os.path.exists(cli_workdir / "data" / bnn.name / f"{bnn.name}_fgsm_attackSamp=10_attack.npz")


def test_resolve_device_alone_turns_tf32_off():
    """Every entry point resolves its device, so a library caller gets exact
    f32 without the CLI: the flags (plain attributes on a CPU build) end False,
    and cuDNN keeps to its deterministic algorithms."""
    from robustbnns_tpu_torch.utils.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is True


def test_attack_false_still_attacks_the_bnn(monkeypatch, tmp_path):
    """``--attack=False`` on the BNN branch produces and evaluates an attack, as
    the JAX package's BNN branch (which never reads the flag) does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    bnn = BNN.from_config(config.saved_BNNs["model_7"], (28, 28, 1), 10, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(7))
    bnn.posterior = MeanFieldPosterior(loc, tuple({k: torch.full_like(v, -6.0) for k, v in p.items()} for p in loc))
    bnn.save(rel_path=config.DATA)
    out = cli.main(["--model_type=bnn", "--model_idx=7", "--train=False", "--attack=False",
                    "--test=False", "--n_inputs=8", "--device=cpu", "--attack_method=fgsm"])
    x, xa = torch.as_tensor(out["x_test"]), out["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and float((xa - x).abs().max()) <= 0.3 + 1e-6
    assert float(((xa - x).abs() > 0).float().mean()) > 0.2
    assert 0.0 <= out["adversarial_accuracy"] <= 100.0 and 0.0 <= out["clean_accuracy"] <= 100.0
    assert os.path.exists(tmp_path / "data" / bnn.name / f"{bnn.name}_fgsm_attackSamp=10_attack.npz")


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--model_type=bnn", "--model_idx=7", "--train=False"])


@pytest.mark.parametrize("kind", ["nn", "ensemble"])
def test_nn_and_ensemble_attacks_match_jax(kind):
    """FGSM and 3-step PGD on an fc2-32 NN, and on a 4-member ensemble's mean
    raw logits, with the same parameters in both packages: the same pixels
    move, to the same values (the final clip's rounding aside), and the
    clean and adversarial accuracies are JAX's."""
    from robustbnns_tpu.attacks.gradient_attacks import fgsm_attack as jax_fgsm
    from robustbnns_tpu.attacks.gradient_attacks import pgd_attack as jax_pgd
    from robustbnns_tpu.models import DeterministicNN as JaxNN
    from robustbnns_tpu.models import EnsembleNN as JaxEnsemble
    from robustbnns_tpu.models import build_architecture as jax_build
    from robustbnns_tpu_torch.attacks.gradient_attacks import fgsm_attack, pgd_attack
    from robustbnns_tpu_torch.models import DeterministicNN, EnsembleNN, build_architecture
    from robustbnns_tpu_torch.utils.checkpoint import params_from_numpy

    shape = (8, 8, 1)
    jarch, tarch = jax_build("fc2", "leaky", shape, 10, 32), build_architecture("fc2", "leaky", shape, 10, 32)
    if kind == "nn":
        params = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.key(1)))
        ref, ours = JaxNN(arch=jarch, params=params), DeterministicNN(tarch, params_from_numpy(params))
    else:
        params = jax.tree_util.tree_map(np.asarray, jax.vmap(jarch.init)(jax.random.split(jax.random.key(1), 4)))
        ref, ours = JaxEnsemble(jarch, params, 4), EnsembleNN(tarch, params_from_numpy(params), 4)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(12,) + shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 12)]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    fn, jfn = ours.predictive_fn(), ref.predictive_fn()
    for got, want in ((fgsm_attack(fn, tx, ty, epsilon=0.3), jax_fgsm(jfn, x, y, epsilon=0.3)),
                      (pgd_attack(fn, tx, ty, epsilon=0.3, iters=3), jax_pgd(jfn, x, y, epsilon=0.3, iters=3))):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy() != x, want != x)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        scores = attack_evaluation(ours, x, got, y, verbose=False)
        ref_scores = jax_attack_evaluation(ref, x, want, y, verbose=False)
        assert scores[:2] == ref_scores[:2]
        np.testing.assert_allclose(scores[2].numpy(), np.asarray(ref_scores[2]), atol=1e-5)


def test_nn_and_ensemble_clis_run_on_the_cpu(cli_workdir, monkeypatch):
    """``cli.train_nn`` trains model_0 (conv-512) on 64 surrogate images,
    saves and reloads it bit-equal; ``cli.attacks --model_type=nn`` attacks
    it (FGSM, 8 images, the data cut to 64 images) and with
    ``--attack=False`` reloads that attack bit-equal; the deterministic loss
    gradients run on it. ``cli.train_ensemble`` trains 10 members of model_5
    (fc2-512) on 100 images and ``cli.attacks --model_type=ensemble`` loads
    and attacks them. No sampled-dense kernel launches."""
    import importlib

    from robustbnns_tpu_torch.analysis import expected_loss_gradients
    from robustbnns_tpu_torch.cli import train_ensemble, train_nn

    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sd.reset_launch_counts()
    flags = ["--model_idx=0", "--n_inputs=64", "--savedir=DATA", "--device=cpu"]
    out = train_nn.main(flags + ["--train=True", "--test=True"])
    model = out["model"]
    loss = model.history["loss"]
    assert len(loss) == 5 and np.isfinite(loss).all() and 0 <= out["test_accuracy"] <= 100
    assert (cli_workdir / "data" / model.name / f"{model.name}_weights.npz").exists()
    loaded = train_nn.main(flags + ["--train=False", "--test=False"])["model"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded.params), tree_leaves(model.params)))

    load = cli.load_data
    monkeypatch.setattr(cli, "load_data", lambda ds, n, shuffle=True: load(ds, n or 64, shuffle))
    attack_flags = ["--model_type=nn", "--model_idx=0", "--train=False", "--n_inputs=8", "--device=cpu"]
    r = cli.main(attack_flags + ["--test=True"])
    x, xa = torch.as_tensor(r["x_test"]), r["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and float((xa - x).abs().max()) <= 0.3 + 1e-6
    assert 0 <= float(xa.min()) and float(xa.max()) <= 1 and 0 <= r["test_accuracy"] <= 100
    again = cli.main(attack_flags + ["--test=False", "--attack=False"])
    assert torch.equal(again["x_attack"], xa) and again["adversarial_accuracy"] == r["adversarial_accuracy"]
    grads = expected_loss_gradients(r["model"], x, r["y_test"], n_samples=None)
    assert grads.shape == x.shape and bool(torch.isfinite(grads).all()) and float(grads.abs().max()) > 0

    ens_flags = ["--model_idx=5", "--n_inputs=100", "--savedir=DATA", "--device=cpu", "--ensemble_size=10"]
    ens = train_ensemble.main(ens_flags + ["--train=True", "--test=False"])["model"]
    assert ens.stacked_params[0]["w"].shape == (10, 784, 512) and len(ens.history["loss"][0]) == 10
    assert ens.history["loss"][0][-1] < ens.history["loss"][0][0]
    r = cli.main(["--model_type=ensemble", "--model_idx=5", "--n_inputs=8", "--device=cpu", "--attack_method=pgd"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r["model"].stacked_params),
                                                 tree_leaves(ens.stacked_params)))
    x, xa = torch.as_tensor(r["x_test"]), r["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and float((xa - x).abs().max()) <= 0.3 + 1e-6
    assert os.path.exists(cli_workdir / "data" / ens.name / f"{ens.name}_pgd_attack.npz")
    assert not any(sd.launch_counts().values())
