#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``robustbnns_tpu_torch``) on one NVIDIA H100.

Run from the repo root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: a CUDA card, its name and power limit, exact f32 (no TF32);
2. build: every kernel under ``robustbnns_tpu_torch/csrc`` with nvcc;
3. kernels: each sampled-dense kernel against its plain PyTorch twin on the
   card, at the shapes the ``model_7`` (fc2-1024) attack gives it, with times;
4. predictive: the fused fc2-1024 predictive and its input gradient through the
   kernels against the plain twins composed the same way;
5. main path: Bayesian FGSM and 40-step PGD on ``model_7`` through the attack
   CLI with ``--fused=True``, on a seeded random posterior written with the
   port's own ``save``; every kernel must launch;
6. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX. Writes only under a temporary directory and the
kernel build directory ``build/kernels``.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B, S = 128, 10  # attack batch and posterior draws per forward (cli/attacks.py)
LAYERS = ((784, 1024), (1024, 1024), (1024, 10))  # model_7: mnist fc2-1024
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Kernel vs plain twin: the same noise and the same products, summed in another
# order (K <= S*O = 10240 terms). Reordering a K-term f32 sum moves it by about
# sqrt(K)*2^-24 of its scale (< 1e-5 here); eps may differ by an ulp where the
# kernel and PyTorch's elementwise code round a transcendental differently.
RTOL, ATOL_OF_MAX = 1e-4, 1e-4
# The whole predictive chains three layers, softmax and CE: each layer's 1e-4
# relative error can grow through the activations, so the end results are held
# to 1e-3 of their largest entry.
E2E_TOL_OF_MAX = 1e-3


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(1)


def check_close(name: str, got, ref, rtol: float, atol: float) -> float:
    err = (got - ref).abs()
    max_err = float(err.max())
    if not bool((err <= atol + rtol * ref.abs()).all()):
        fail(f"{name}: kernel disagrees with its plain twin (max |err| {max_err:.3e}, "
             f"atol {atol:.3e}, rtol {rtol:.0e})")
    return max_err


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from robustbnns_tpu_torch.utils.device import exact_f32

    exact_f32()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from robustbnns_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for source, log in build.build_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {source}: {line.strip()}")


def _layer_inputs(torch, gen, i_dim, o_dim):
    bound = 1.0 / math.sqrt(i_dim)
    u = lambda *shape: (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * bound  # noqa: E731
    rho = torch.randn((i_dim, o_dim), generator=gen, device="cuda") * 0.5 - 4.0
    brho = torch.randn((o_dim,), generator=gen, device="cuda") * 0.5 - 4.0
    return u(i_dim, o_dim), rho, u(o_dim), brho


def phase_kernels(torch) -> dict:
    """Each kernel vs its plain twin on the card at the main path's shapes."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    seed = 20261016
    results = {}

    def record(name, route_src, replaces, shape, got, ref, run, plain, lib, flops, nbytes):
        atol = ATOL_OF_MAX * float(ref.abs().max())
        err = check_close(f"{name} {shape}", got, ref, RTOL, atol)
        ms, plain_ms, lib_ms = time_ms(torch, run), time_ms(torch, plain), time_ms(torch, lib)
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"[kernel] {name} {shape}: max|err| {err:.3e} (tol {atol:.3e} + {RTOL:.0e}|ref|) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        r = results.setdefault(name, {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0, "library_ms": 0.0, "shapes": [],
        })
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", b_ms), ("flops", flops), ("bytes", nbytes)):
            r[key] += v
        r["shapes"].append(shape)

    fwd_src = "robustbnns_tpu_torch/csrc/sampled_dense_fwd.cu"
    dx_src = "robustbnns_tpu_torch/csrc/sampled_dense_dx.cu"
    pallas = "robustbnns_tpu/ops/sampled_dense.py"
    for li, (i_dim, o_dim) in enumerate(LAYERS):
        loc, rho, bloc, brho = _layer_inputs(torch, gen, i_dim, o_dim)
        w, b = sd.sampled_weights(loc, rho, bloc, brho, S, seed)  # for the library yardstick
        g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
        flops = 2.0 * S * B * i_dim * o_dim
        shape = f"B={B} S={S} I={i_dim} O={o_dim}"
        if li == 0:
            x = torch.rand((B, i_dim), generator=gen, device="cuda")
            args = (x, loc, rho, bloc, brho, S, seed)
            record("sampled_dense_fwd", fwd_src, f"{pallas}:99", shape,
                   sd.sampled_dense_fwd(*args), sd.sampled_dense_fwd_plain(*args),
                   lambda: sd.sampled_dense_fwd(*args), lambda: sd.sampled_dense_fwd_plain(*args),
                   lambda: torch.baddbmm(b.unsqueeze(1), x.expand(S, B, i_dim), w),
                   flops, 4.0 * (B * i_dim + 2 * i_dim * o_dim + 2 * o_dim + S * B * o_dim))
            dargs = (g, loc, rho, S, seed)
            record("sampled_dense_dx", dx_src, f"{pallas}:114", shape,
                   sd.sampled_dense_dx(*dargs), sd.sampled_dense_dx_plain(*dargs),
                   lambda: sd.sampled_dense_dx(*dargs), lambda: sd.sampled_dense_dx_plain(*dargs),
                   lambda: torch.einsum("sbo,sio->bi", g, w),
                   flops, 4.0 * (S * B * o_dim + 2 * i_dim * o_dim + B * i_dim))
        else:
            xs = torch.nn.functional.leaky_relu(
                torch.randn((S, B, i_dim), generator=gen, device="cuda"), 0.01)
            args = (xs, loc, rho, bloc, brho, S, seed)
            record("sampled_dense_xs_fwd", fwd_src, f"{pallas}:347", shape,
                   sd.sampled_dense_xs_fwd(*args), sd.sampled_dense_xs_fwd_plain(*args),
                   lambda: sd.sampled_dense_xs_fwd(*args),
                   lambda: sd.sampled_dense_xs_fwd_plain(*args),
                   lambda: torch.baddbmm(b.unsqueeze(1), xs, w),
                   flops, 4.0 * (S * B * i_dim + 2 * i_dim * o_dim + 2 * o_dim + S * B * o_dim))
            dargs = (g, loc, rho, S, seed)
            record("sampled_dense_xs_dx", dx_src, f"{pallas}:362", shape,
                   sd.sampled_dense_xs_dx(*dargs), sd.sampled_dense_xs_dx_plain(*dargs),
                   lambda: sd.sampled_dense_xs_dx(*dargs),
                   lambda: sd.sampled_dense_xs_dx_plain(*dargs),
                   lambda: torch.bmm(g, w.transpose(1, 2)),
                   flops, 4.0 * (S * B * o_dim + 2 * i_dim * o_dim + S * B * i_dim))
    torch.cuda.synchronize()
    return results


def model7_posterior(torch, arch):
    """A seeded random posterior at model_7's widths: loc from the torch-default
    init, softplus(rho) = 1e-2 of each layer's init bound. The reference's
    N(0, 1) init (``init_meanfield``) saturates the softmax of an untrained
    fc2-1024, and the attack gradients then vanish."""
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior

    loc = arch.init(torch.Generator(device="cuda").manual_seed(7))
    rho = tuple(
        {k: torch.full_like(v, math.log(math.expm1(1e-2 / math.sqrt(i_dim)))) for k, v in layer.items()}
        for layer, (i_dim, _) in zip(loc, arch.dims)
    )
    return MeanFieldPosterior(loc=loc, rho=rho)


def phase_predictive(torch) -> None:
    """The fused predictive and its input gradient: kernels vs composed plain twins."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
    from robustbnns_tpu_torch.models.architectures import ACTIVATIONS, build_architecture
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    from robustbnns_tpu_torch.ops.fused_predict import layer_seed, svi_predict_fused

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "mnist")
    post = model7_posterior(torch, arch)
    act = ACTIVATIONS["leaky"]
    seed = 99

    def plain(x):
        loc, rho = post.loc, post.rho
        h = sd.sampled_dense_fwd_plain(x.reshape(B, -1), loc[0]["w"], rho[0]["w"], loc[0]["b"],
                                       rho[0]["b"], S, layer_seed(seed, 0))
        for li in (1, 2):
            h = sd.sampled_dense_xs_fwd_plain(act(h), loc[li]["w"], rho[li]["w"], loc[li]["b"],
                                              rho[li]["b"], S, layer_seed(seed, li))
        return torch.softmax(h, -1).mean(0)

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((B, 28, 28, 1), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda")
    outs = []
    for fn in (lambda x: svi_predict_fused(arch, post, x, S, seed), plain):
        xr = x.clone().requires_grad_(True)
        probs = fn(xr)
        (grad,) = torch.autograd.grad(ce_on_outputs(probs, labels).sum(), xr)
        outs.append((probs.detach(), grad))
    (p_k, g_k), (p_p, g_p) = outs
    if not (torch.isfinite(p_k).all() and torch.isfinite(g_k).all()):
        fail("fused predictive gave non-finite values")
    if not torch.allclose(p_k.sum(-1), torch.ones(B, device="cuda"), atol=1e-5):
        fail("fused predictive rows do not sum to 1")
    print(f"[predictive] fc2-1024 B={B} S={S}: probs max|err| {float((p_k - p_p).abs().max()):.3e}, "
          f"input-gradient max|err| {float((g_k - g_p).abs().max()):.3e} "
          f"(max|grad| {float(g_p.abs().max()):.3e})")
    check_close("predictive probs", p_k, p_p, 0.0, E2E_TOL_OF_MAX * float(p_p.abs().max()))
    check_close("predictive input gradient", g_k, g_p, 0.0, E2E_TOL_OF_MAX * float(g_p.abs().max()))


def phase_main_path(torch, workdir: str) -> dict:
    """FGSM and PGD on model_7 through the attack CLI, fused, counting launches."""
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.config import DATA, saved_BNNs
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts

    if not os.path.abspath(DATA).startswith(workdir):
        fail(f"ROBUSTBNNS_DATA was not redirected to the temporary directory ({DATA})")
    bnn = BNN.from_config(saved_BNNs["model_7"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = model7_posterior(torch, bnn.arch)
    bnn.save(rel_path=DATA)

    n_inputs, eps = 256, 0.3
    flags = ["--model_type=bnn", "--model_idx=7", "--fused=True", "--train=False",
             "--test=True", f"--n_inputs={n_inputs}", "--device=cuda"]
    reset_launch_counts()
    runs = {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[main] launches over FGSM + PGD: {json.dumps(counts)}")
    if not all(n > 0 for n in counts.values()):
        fail(f"a kernel of the main path never launched: {counts}")
    for method, r in runs.items():
        xa = r["x_attack"]
        x = torch.as_tensor(r["x_test"], device=xa.device)
        if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
            fail(f"{method}: adversarial set has shape {tuple(xa.shape)} or non-finite values")
        if float((xa - x).abs().max()) > eps + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
            fail(f"{method}: adversarial set leaves the eps-ball or [0, 1]")
        moved = float(((xa - x).abs() > 1e-6).float().mean())
        if moved < 0.2:
            fail(f"{method}: only {moved:.1%} of pixels moved")
        print(f"[main] {method}: test acc {r['test_accuracy']:.2f}% | clean acc "
              f"{r['clean_accuracy']:.2f}% adversarial acc {r['adversarial_accuracy']:.2f}% | "
              f"softmax robustness {float(r['softmax_robustness'].mean()):.4f} | "
              f"{moved:.1%} pixels moved | attack {r['attack_seconds']:.3f} s = "
              f"{n_inputs / r['attack_seconds']:.1f} images/s")
    return counts


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        os.environ["ROBUSTBNNS_DATA"] = os.path.join(workdir, "data") + "/"
        os.environ["ROBUSTBNNS_TESTS"] = os.path.join(workdir, "tests_out") + "/"
        os.environ["ROBUSTBNNS_SYNTH_CACHE"] = os.path.join(workdir, "synthetic")
        try:
            import robustbnns_tpu_torch  # noqa: F401
        except ImportError as e:
            fail(f"the port is not importable ({e}): run from the repository root")
        if any(m == "jax" or m.startswith(("jax.", "robustbnns_tpu.")) for m in sys.modules):
            fail("the port imported JAX or the JAX package")
        phase_device(torch)
        phase_build()
        kernels = phase_kernels(torch)
        phase_predictive(torch)
        counts = phase_main_path(torch, workdir)
    line = []
    for name, r in kernels.items():
        line.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_ms(r["flops"], r["bytes"])[1], "library_ms": r["library_ms"],
            "shapes": r["shapes"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
