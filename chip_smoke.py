#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``robustbnns_tpu_torch``) on one NVIDIA H100.

Run from the repo root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: a CUDA card, its name and power limit, exact f32 (no TF32);
2. build: every kernel under ``robustbnns_tpu_torch/csrc`` with nvcc;
3. kernels: each of the six sampled-dense kernels against its plain PyTorch
   twin on the card, at the shapes ``model_7`` (fc2-1024) gives it, with
   times: device time (a CUDA graph of 20 calls) of the kernel, its twin and
   one library call, and ``call_ms``, one kernel call on an idle stream;
4. edges: the two forward kernels at edge shapes (one row, O = 13, the head
   at S = 1, S = 100, B = 2048, I = 3072, the Half Moons widths) against their
   twins, bit-identical across calls, and xs_fwd on a broadcast x equal to
   fwd; the two input-gradient kernels at edge shapes (one row, O = 13, the
   head at S = 1, S = 100, B = 2048, O = 4000) against their twins,
   bit-identical across calls, and dx against the sum of dxs; the two
   parameter-gradient kernels at the forward's edge shapes and O = 4000
   against their twins, bit-identical across calls, and xs_dparams on a
   broadcast x equal to dparams;
5. predictive: the fused fc2-1024 predictive and its input gradient through the
   kernels against the plain twins composed the same way;
6. parameter gradient: the gradient of the fused predictive's cross-entropy
   with respect to all 12 posterior leaves, through the dparams kernels,
   against the composed twins at S = 10; and at S = 1 the fused gradient of
   -sum log p(y | x, w) against autograd of the materialised network on the
   same noise, the identity that ties the kernels to SVI training; the
   dparams kernels must launch and the dx kernel of the unasked input must not;
7. main path: Bayesian FGSM and 40-step PGD on ``model_7`` through the attack
   CLI with ``--fused=True``, on a seeded random posterior written with the
   port's own ``save``; the four attack kernels must launch, the dparams
   kernels must not;
   then the wall clock of 40-step PGD (median of three) against the device
   time of its kernels (``torch.profiler``);
8. training: ``model_7`` trained at full width for its 5 configured epochs on
   60,000 surrogate MNIST images through the attack CLI with ``--train=True``,
   then attacked by PGD: a finite, falling loss, a posterior that moved and
   carries no ``requires_grad``, and no dparams launch during the attack;
   then the wall and device time of 20 SVI steps (``torch.profiler``);
9. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` as the last line.
   ``launches`` counts the dparams kernels over phase 6 and the others over
   phase 7.

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
DPARAMS = ("sampled_dense_dparams", "sampled_dense_xs_dparams")


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


def call_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings on an idle stream: what a caller
    waits for, the host's work before the launch included."""
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


def device_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``calls`` back-to-back calls captured in one
    CUDA graph, replayed between two CUDA events; the median over ``replays``
    replays, divided by ``calls``. A spin kernel ahead of the start event keeps
    the host's launch of the graph out of the window, and the graph removes the
    host's work between calls, so a kernel and a library call are timed alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # about 0.5 ms: the replay is queued before start fires
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.synchronize()
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
        if torch.is_tensor(got):
            got, ref = (got,), (ref,)
        atol = err = 0.0
        for k, (got_k, ref_k) in enumerate(zip(got, ref)):
            atol_k = ATOL_OF_MAX * float(ref_k.abs().max())
            err = max(err, check_close(f"{name} {shape} output {k}", got_k, ref_k, RTOL, atol_k))
            atol = max(atol, atol_k)
        c_ms = call_ms(torch, run)
        ms, plain_ms, lib_ms = device_ms(torch, run), device_ms(torch, plain), device_ms(torch, lib)
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"[kernel] {name} {shape}: max|err| {err:.3e} (tol {atol:.3e} + {RTOL:.0e}|ref|) "
              f"kernel {ms:.4f} ms (call {c_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of the kernel)")
        r = results.setdefault(name, {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0, "library_ms": 0.0, "per_shape": [],
        })
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, v in (("ms", ms), ("call_ms", c_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", b_ms), ("flops", flops), ("bytes", nbytes)):
            r[key] += v
        r["per_shape"].append({"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                               "max_abs_err": err})

    fwd_src = "robustbnns_tpu_torch/csrc/sampled_dense_fwd.cu"
    dx_src = "robustbnns_tpu_torch/csrc/sampled_dense_dx.cu"
    dp_src = "robustbnns_tpu_torch/csrc/sampled_dense_dparams.cu"
    # dparams: reads g, the input, rho and brho once; writes dloc, drho, dbloc, dbrho
    dp_bytes = lambda x_numel, i_dim, o_dim: 4.0 * (  # noqa: E731
        S * B * o_dim + x_numel + 3 * i_dim * o_dim + 3 * o_dim)
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
            pargs = (g, x, rho, brho, S, seed)
            xt = x.t().expand(S, i_dim, B)
            record("sampled_dense_dparams", dp_src, f"{pallas}:137", shape,
                   sd.sampled_dense_dparams(*pargs), sd.sampled_dense_dparams_plain(*pargs),
                   lambda: sd.sampled_dense_dparams(*pargs),
                   lambda: sd.sampled_dense_dparams_plain(*pargs),
                   lambda: torch.bmm(xt, g),  # the S products dW_s, without the epilogue
                   flops, dp_bytes(B * i_dim, i_dim, o_dim))
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
            pargs = (g, xs, rho, brho, S, seed)
            xst = xs.transpose(1, 2)
            record("sampled_dense_xs_dparams", dp_src, f"{pallas}:383", shape,
                   sd.sampled_dense_xs_dparams(*pargs), sd.sampled_dense_xs_dparams_plain(*pargs),
                   lambda: sd.sampled_dense_xs_dparams(*pargs),
                   lambda: sd.sampled_dense_xs_dparams_plain(*pargs),
                   lambda: torch.bmm(xst, g),  # the S products dW_s, without the epilogue
                   flops, dp_bytes(S * B * i_dim, i_dim, o_dim))
    torch.cuda.synchronize()
    return results


# (B, I, O, S) beyond the main path: one row, the ragged narrow path, the head
# at S = 1, S = 100, a batch of 16 row tiles, CIFAR-10's input width (beyond
# what a per-block softplus(rho) slice in shared memory allows), and the Half
# Moons hidden layer and head
FWD_EDGE_SHAPES = ((1, 784, 1024, 10), (37, 784, 13, 3), (128, 1024, 10, 1), (128, 784, 1024, 100),
                   (2048, 784, 1024, 10), (64, 3072, 512, 2), (100, 2, 32, 10), (100, 32, 2, 10))
# (B, I, O, S) beyond the main path: one row, the ragged narrow path, the head
# at S = 1, S = 100, a batch of 16 row tiles, and an O whose whole
# softplus(rho) slice fits no block's shared memory
DX_EDGE_SHAPES = ((1, 784, 1024, 10), (37, 784, 13, 3), (128, 1024, 10, 1),
                  (128, 784, 1024, 100), (2048, 784, 1024, 10), (64, 256, 4000, 2))


def _plan_text(plan) -> str:
    return ("narrow, " if plan.narrow else "") + f"{plan.n_split} runs a tile, {math.prod(plan.grid)} blocks"


def phase_fwd_edges(torch) -> None:
    """The two forward kernels at edge shapes: against their twins,
    bit-identical across two calls, and xs_fwd on a broadcast x equal to fwd."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = 78
    for b, i, o, s in FWD_EDGE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * 7919 + i * 31 + o)
        params = (*_layer_inputs(torch, gen, i, o), s, seed)
        x = torch.rand((b, i), generator=gen, device="cuda")
        xs = torch.rand((s, b, i), generator=gen, device="cuda")
        shape = f"B={b} I={i} O={o} S={s}"
        out, out_xs = sd.sampled_dense_fwd(x, *params), sd.sampled_dense_xs_fwd(xs, *params)
        if not (torch.equal(out, sd.sampled_dense_fwd(x, *params))
                and torch.equal(out_xs, sd.sampled_dense_xs_fwd(xs, *params))):
            fail(f"[fwd-edge] {shape}: two calls differ")
        if not torch.equal(out, sd.sampled_dense_xs_fwd(x.expand(s, b, i).contiguous(), *params)):
            fail(f"[fwd-edge] {shape}: xs_fwd on a broadcast x differs from fwd")
        errs = []
        for name, got, ref in (("sampled_dense_fwd", out, sd.sampled_dense_fwd_plain(x, *params)),
                               ("sampled_dense_xs_fwd", out_xs, sd.sampled_dense_xs_fwd_plain(xs, *params))):
            if not bool(torch.isfinite(got).all()):
                fail(f"[fwd-edge] {name} {shape}: non-finite values")
            errs.append(check_close(f"[fwd-edge] {name} {shape}", got, ref, RTOL,
                                    ATOL_OF_MAX * float(ref.abs().max())))
        plan = sd.fwd_plan(s, b, i, o, sms)
        times = [device_ms(torch, lambda: sd.sampled_dense_fwd(x, *params), calls=5, replays=3),
                 device_ms(torch, lambda: sd.sampled_dense_xs_fwd(xs, *params), calls=5, replays=3)]
        print(f"[fwd-edge] {shape}: max|err| fwd {errs[0]:.3e}, xs_fwd {errs[1]:.3e}; bit-identical "
              f"repeat, xs_fwd on a broadcast x equals fwd; fwd {times[0]:.4f} ms, xs_fwd "
              f"{times[1]:.4f} ms ({_plan_text(plan)})")
    del out, out_xs, x, xs
    torch.cuda.empty_cache()


def phase_dx_edges(torch) -> None:
    """The two dx kernels at edge shapes: against their twins, bit-identical
    across two calls, and dx against the sum over samples of dxs."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = 77
    for b, i, o, s in DX_EDGE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * 7919 + i * 31 + o)
        loc, rho, _, _ = _layer_inputs(torch, gen, i, o)
        g = torch.randn((s, b, o), generator=gen, device="cuda")
        args = (g, loc, rho, s, seed)
        shape = f"B={b} I={i} O={o} S={s}"
        dx, dxs = sd.sampled_dense_dx(*args), sd.sampled_dense_xs_dx(*args)
        if not (torch.equal(dx, sd.sampled_dense_dx(*args)) and torch.equal(dxs, sd.sampled_dense_xs_dx(*args))):
            fail(f"[dx-edge] {shape}: two calls differ")
        errs = []
        for name, got, ref in (("sampled_dense_dx", dx, sd.sampled_dense_dx_plain(*args)),
                               ("sampled_dense_xs_dx", dxs, sd.sampled_dense_xs_dx_plain(*args)),
                               ("dx against the sum of dxs", dx, dxs.sum(0))):
            if not bool(torch.isfinite(got).all()):
                fail(f"[dx-edge] {name} {shape}: non-finite values")
            errs.append(check_close(f"[dx-edge] {name} {shape}", got, ref, RTOL,
                                    ATOL_OF_MAX * float(ref.abs().max())))
        plans = [sd.dx_plan(s, b, i, o, sms, summed) for summed in (True, False)]
        times = [device_ms(torch, lambda: sd.sampled_dense_dx(*args), calls=5, replays=3),
                 device_ms(torch, lambda: sd.sampled_dense_xs_dx(*args), calls=5, replays=3)]
        print(f"[dx-edge] {shape}: max|err| dx {errs[0]:.3e}, dxs {errs[1]:.3e}, dx - sum dxs "
              f"{errs[2]:.3e}; bit-identical repeat; dx {times[0]:.4f} ms ({_plan_text(plans[0])}), "
              f"dxs {times[1]:.4f} ms ({_plan_text(plans[1])})")
    del dx, dxs, g
    torch.cuda.empty_cache()


# (B, I, O, S): the forward's edge shapes and an O of 63 output tiles
DPARAMS_EDGE_SHAPES = FWD_EDGE_SHAPES + ((64, 256, 4000, 2),)


def phase_dparams_edges(torch) -> None:
    """The two dparams kernels at edge shapes: against their twins,
    bit-identical across two calls, and xs_dparams on a broadcast x equal to
    dparams."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = 79
    for b, i, o, s in DPARAMS_EDGE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * 7919 + i * 31 + o)
        _, rho, _, brho = _layer_inputs(torch, gen, i, o)
        g = torch.randn((s, b, o), generator=gen, device="cuda")
        x = torch.rand((b, i), generator=gen, device="cuda")
        xs = torch.rand((s, b, i), generator=gen, device="cuda")
        tail = (rho, brho, s, seed)
        shape = f"B={b} I={i} O={o} S={s}"
        got, got_xs = sd.sampled_dense_dparams(g, x, *tail), sd.sampled_dense_xs_dparams(g, xs, *tail)
        again = sd.sampled_dense_dparams(g, x, *tail) + sd.sampled_dense_xs_dparams(g, xs, *tail)
        if not all(torch.equal(a, c) for a, c in zip(got + got_xs, again)):
            fail(f"[dparams-edge] {shape}: two calls differ")
        broadcast = sd.sampled_dense_xs_dparams(g, x.expand(s, b, i).contiguous(), *tail)
        if not all(torch.equal(a, c) for a, c in zip(broadcast, got)):
            fail(f"[dparams-edge] {shape}: xs_dparams on a broadcast x differs from dparams")
        errs = []
        for name, outs, refs in (("sampled_dense_dparams", got, sd.sampled_dense_dparams_plain(g, x, *tail)),
                                 ("sampled_dense_xs_dparams", got_xs,
                                  sd.sampled_dense_xs_dparams_plain(g, xs, *tail))):
            err = 0.0
            for k, (got_k, ref_k) in enumerate(zip(outs, refs)):
                if not bool(torch.isfinite(got_k).all()):
                    fail(f"[dparams-edge] {name} {shape} output {k}: non-finite values")
                err = max(err, check_close(f"[dparams-edge] {name} {shape} output {k}", got_k, ref_k, RTOL,
                                           ATOL_OF_MAX * float(ref_k.abs().max())))
            errs.append(err)
        plan = sd.dparams_plan(s, i, o, sms)
        times = [device_ms(torch, lambda: sd.sampled_dense_dparams(g, x, *tail), calls=5, replays=3),
                 device_ms(torch, lambda: sd.sampled_dense_xs_dparams(g, xs, *tail), calls=5, replays=3)]
        print(f"[dparams-edge] {shape}: max|err| dparams {errs[0]:.3e}, xs_dparams {errs[1]:.3e}; "
              f"bit-identical repeat, xs_dparams on a broadcast x equals dparams; dparams {times[0]:.4f} ms, "
              f"xs_dparams {times[1]:.4f} ms ({_plan_text(plan)})")
    del got, got_xs, again, broadcast, g, x, xs
    torch.cuda.empty_cache()


def model7_posterior(torch, arch, rel_scale: float = 1e-2, rho_spread: float = 0.0):
    """A seeded random posterior at model_7's widths: loc from the torch-default
    init, softplus(rho) = ``rel_scale`` of each layer's init bound, rho spread
    by ``rho_spread``·N(0, 1). The reference's N(0, 1) init (``init_meanfield``)
    saturates the softmax of an untrained fc2-1024, and the attack gradients
    then vanish."""
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior

    gen = torch.Generator(device="cuda").manual_seed(7)
    loc = arch.init(gen)
    rho = tuple(
        {k: math.log(math.expm1(rel_scale / math.sqrt(i_dim)))
         + rho_spread * torch.randn(v.shape, generator=gen, device="cuda") for k, v in layer.items()}
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


def phase_param_grad(torch) -> dict:
    """The posterior-parameter gradient of the fused predictive, through the
    dparams kernels: against the composed twins at S = 10, and at S = 1
    against the ELBO likelihood term's gradient on the materialised draw."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
    from robustbnns_tpu_torch.inference.svi import categorical_loglik_sum, sample_meanfield_eps
    from robustbnns_tpu_torch.models.architectures import ACTIVATIONS, build_architecture
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    from robustbnns_tpu_torch.ops.fused_predict import fused_logits, layer_seed, svi_predict_fused
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "mnist")
    post = model7_posterior(torch, arch, rel_scale=0.5, rho_spread=0.3)
    act = ACTIVATIONS["leaky"]
    seed = 4242
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((B, 28, 28, 1), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda")

    def plain(p, n_samples):
        loc, rho = p.loc, p.rho
        h = sd.sampled_dense_fwd_plain(x.reshape(B, -1), loc[0]["w"], rho[0]["w"], loc[0]["b"],
                                       rho[0]["b"], n_samples, layer_seed(seed, 0))
        for li in (1, 2):
            h = sd.sampled_dense_xs_fwd_plain(act(h), loc[li]["w"], rho[li]["w"], loc[li]["b"],
                                              rho[li]["b"], n_samples, layer_seed(seed, li))
        return torch.softmax(h, -1).mean(0)

    def grads(loss_of):
        leaves = type(post)(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()}
                                    for layer in tree) for tree in post))
        flat = tree_leaves(leaves.loc) + tree_leaves(leaves.rho)
        return torch.autograd.grad(loss_of(leaves), flat)

    names = [f"{t}/{li}/{k}" for t in ("loc", "rho") for li in range(3) for k in ("b", "w")]
    sd.reset_launch_counts()
    fused = grads(lambda p: ce_on_outputs(svi_predict_fused(arch, p, x, S, seed), labels).sum())
    torch.cuda.synchronize()
    counts = sd.launch_counts()
    twin = grads(lambda p: ce_on_outputs(plain(p, S), labels).sum())
    worst = 0.0
    for name, got, ref in zip(names, fused, twin):
        if not bool(torch.isfinite(got).all()):
            fail(f"parameter gradient {name} is not finite")
        worst = max(worst, check_close(f"S={S} gradient {name}", got, ref, 0.0,
                                       E2E_TOL_OF_MAX * float(ref.abs().max())) / float(ref.abs().max()))
    print(f"[param-grad] fc2-1024 B={B} S={S}: 12 leaves within {worst:.3e} of max|ref| "
          f"(tol {E2E_TOL_OF_MAX:.0e}); launches {json.dumps(counts)}")
    if counts["sampled_dense_dparams"] == 0 or counts["sampled_dense_xs_dparams"] == 0:
        fail(f"the parameter gradient did not run the dparams kernels: {counts}")
    if counts["sampled_dense_dx"] != 0:
        fail(f"the parameter gradient launched the dx kernel for an input that asked for none: {counts}")

    # S = 1: the fused gradient of -sum log p(y | x, w) is the ELBO likelihood
    # term's gradient on the materialised draw with the kernels' own noise
    eps = []
    for li, (i_dim, o_dim) in enumerate(arch.dims):
        e = sd.sampled_noise(layer_seed(seed, li), 1, i_dim + 1, o_dim, "cuda")[0]
        eps.append({"w": e[:i_dim], "b": e[i_dim]})
    fused1 = grads(lambda p: -categorical_loglik_sum(fused_logits(arch, p, x, 1, seed)[0], labels))
    dense1 = grads(lambda p: -categorical_loglik_sum(arch.apply(sample_meanfield_eps(p, tuple(eps)), x), labels))
    worst = 0.0
    for name, got, ref in zip(names, fused1, dense1):
        worst = max(worst, check_close(f"S=1 identity {name}", got, ref, 0.0,
                                       E2E_TOL_OF_MAX * float(ref.abs().max())) / float(ref.abs().max()))
    print(f"[param-grad] S=1 fused vs materialised ELBO likelihood gradient: 12 leaves within "
          f"{worst:.3e} of max|ref|")
    return counts


def check_attack_launches(phase: str, counts: dict) -> None:
    """An attack runs the four forward and dx kernels and no dparams kernel."""
    if not all(n > 0 for name, n in counts.items() if name not in DPARAMS):
        fail(f"[{phase}] a kernel of the attack never launched: {counts}")
    if any(counts[name] for name in DPARAMS):
        fail(f"[{phase}] the attack launched a parameter-gradient kernel: {counts}")


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
    check_attack_launches("main", counts)
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


def phase_attack_profile(torch) -> None:
    """Wall clock and device time of 40-step PGD at model_7's widths, as the
    CLI runs it (256 images in batches of 128, S = 10, fused): the median
    wall time of three unprofiled attacks, and the device time of their
    kernels under ``torch.profiler`` in a fourth."""
    from torch.profiler import ProfilerActivity, profile

    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.models.bnn import BNN

    bnn = BNN.from_config(saved_BNNs["model_7"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = model7_posterior(torch, bnn.arch)
    gen = torch.Generator(device="cuda").manual_seed(13)
    n, iters = 2 * B, 2 * 40
    x = torch.rand((n, 28, 28, 1), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (n,), generator=gen, device="cuda"), 10).float()
    run = lambda: attack(bnn, x, y, method="pgd", n_samples=S, fused=True, save=False, verbose=False)  # noqa: E731
    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                    for e in prof.key_averages())
    if device_us <= 0:
        fail("[attack-profile] torch.profiler saw no device time")
    wall = statistics.median(walls)
    it_ms, dev_ms = 1e3 * wall / iters, 1e-3 * device_us / iters
    print(f"[attack-profile] PGD, 40 steps on {n} images, S={S}: {n / wall:.1f} images/s (median of "
          f"{[round(n / w, 1) for w in walls]}); an iteration {it_ms:.3f} ms wall, {dev_ms:.3f} ms of "
          f"device kernels (device idle {100 * (1 - dev_ms / it_ms):.1f}% of the iteration)")


def phase_training(torch) -> None:
    """Train model_7 through the attack CLI, then attack the trained posterior."""
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.inference.svi import svi_init
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    flags = ["--model_type=bnn", "--model_idx=7", "--train=True", "--fused=True",
             "--attack_method=pgd", "--n_inputs=256", "--device=cuda"]
    reset_launch_counts()
    r = cli.main(flags)
    torch.cuda.synchronize()
    counts = launch_counts()
    bnn = r["bnn"]
    loss, acc, secs = bnn.history["loss"], bnn.history["accuracy"], bnn.history["seconds"]
    epochs, n_train = bnn.config.epochs, r["train_images"]
    later = secs[1:] or secs  # the first epoch also pays the process's first training launches
    print(f"[train] model_7 fc2-1024, {epochs} epochs of {n_train} images, batch 128: "
          f"{r['train_seconds']:.3f} s in all, {epochs * n_train / r['train_seconds']:.1f} training "
          f"images/s; seconds per epoch {[round(v, 3) for v in secs]}, epochs 2-{epochs} at "
          f"{len(later) * n_train / sum(later):.1f} images/s; loss per image "
          f"{[round(v / n_train, 4) for v in loss]}; train accuracy {acc}")
    if not all(math.isfinite(v) for v in loss):
        fail(f"[train] non-finite epoch loss: {loss}")
    if not loss[-1] < loss[0]:
        fail(f"[train] the loss did not fall: {loss}")
    post = bnn.posterior
    leaves = tree_leaves(post.loc) + tree_leaves(post.rho)
    if any(v.requires_grad for v in leaves):
        fail("[train] the trained posterior keeps requires_grad leaves")
    init = svi_init(bnn.arch, torch.Generator(device="cuda").manual_seed(0))
    if all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(init.loc) + tree_leaves(init.rho))):
        fail("[train] the posterior equals its init")
    print(f"[train] launches over training + PGD: {json.dumps(counts)}")
    check_attack_launches("train", counts)
    xa, x = r["x_attack"], torch.as_tensor(r["x_test"], device="cuda")
    if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
        fail(f"[train] adversarial set has shape {tuple(xa.shape)} or non-finite values")
    if float((xa - x).abs().max()) > 0.3 + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
        fail("[train] adversarial set leaves the eps-ball or [0, 1]")
    moved = float(((xa - x).abs() > 1e-6).float().mean())
    print(f"[train] trained model_7: test acc {r['test_accuracy']:.2f}% | clean acc "
          f"{r['clean_accuracy']:.2f}% adversarial acc {r['adversarial_accuracy']:.2f}% | "
          f"{moved:.1%} pixels moved | PGD {r['attack_seconds']:.3f} s = "
          f"{len(x) / r['attack_seconds']:.1f} images/s")


def phase_train_profile(torch) -> None:
    """Host and device time of 20 SVI steps at model_7's widths: the wall clock
    of an unprofiled epoch, and the device time of its kernels under
    ``torch.profiler`` in a second, identical epoch."""
    from torch.profiler import ProfilerActivity, profile

    from robustbnns_tpu_torch.inference.svi import svi_train
    from robustbnns_tpu_torch.models.architectures import build_architecture

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "mnist")
    gen = torch.Generator(device="cuda").manual_seed(3)
    steps, n = 20, 20 * B
    x = torch.rand((n, 28, 28, 1), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (n,), generator=gen, device="cuda"), 10).float()
    run = lambda: svi_train(arch, x, y, epochs=1, lr=0.02, batch_size=B, verbose=False, device="cuda")  # noqa: E731
    wall = run()[1]["seconds"][0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                    for e in prof.key_averages())
    if device_us <= 0:
        fail("[train-profile] torch.profiler saw no device time")
    step_ms, dev_ms = 1e3 * wall / steps, 1e-3 * device_us / steps
    print(f"[train-profile] SVI step at fc2-1024, batch {B}, 10-draw train accuracy: "
          f"{step_ms:.3f} ms wall, {dev_ms:.3f} ms of device kernels "
          f"(device idle {100 * (1 - dev_ms / step_ms):.1f}% of the step)")


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
        phase_fwd_edges(torch)
        phase_dx_edges(torch)
        phase_dparams_edges(torch)
        phase_predictive(torch)
        grad_counts = phase_param_grad(torch)
        counts = phase_main_path(torch, workdir)
        phase_attack_profile(torch)
        phase_training(torch)
        phase_train_profile(torch)
    line = []
    for name, r in kernels.items():
        line.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": (grad_counts if name in DPARAMS else counts)[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_ms(r["flops"], r["bytes"])[1], "library_ms": r["library_ms"],
            "per_shape": r["per_shape"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
