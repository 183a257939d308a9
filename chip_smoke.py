#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``robustbnns_tpu_torch``) on one NVIDIA H100.

Run from the repo root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

0. env: the versions of torch, CUDA, numpy and scipy, and which of
   matplotlib, pandas, seaborn and sklearn import;
1. device: a CUDA card, its name and power limit, and exact f32 (no TF32)
   from ``resolve_device`` alone, with both flags set True before it;
2. build: every kernel under ``robustbnns_tpu_torch/csrc`` with nvcc;
3. kernels: each of the six sampled-dense kernels against its plain PyTorch
   twin on the card, at the shapes ``model_7`` (fc2-1024) gives it, with
   times: device time (a CUDA graph of 20 calls) of the kernel, its twin and
   one library call, and ``call_ms``, one kernel call on an idle stream;
   then ``[reference]``: the four forward kernels (f32 and bf16, shared and
   per-sample input) against ``sampled_dense_reference`` (independent
   ``torch.randn`` draws) at model_7's first layer, B = 128, S = 256: the
   global mean within 0.05 and the mean per-entry std within 5% (the JAX
   package's TPU gates), equal at zero scale, and for the f32 kernels their
   33.5 M draws themselves (one-hot x) against N(0, 1) within 5 sigma in
   mean, variance and the share beyond 3, the reference's as a control;
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
   then ``[precision]``, the bf16 opt-ins: the four bf16 tensor-core kernels
   (``ROBUSTBNNS_KERNEL_PRECISION=default``) against their bf16 twins (the
   f32 gate + 2^-7 of the largest term |x_i||W_si|), against the f32 kernels
   (the bf16 rounding bound), and nearer the twin than a tenth of their
   distance from the f32 kernel, at model_7's shapes and the edge shapes,
   bit-identical across calls, timed beside the f32 kernels (the three
   forward and per-sample ones of ``csrc/sampled_dense_xs_bf16.cu``, on
   ``xs_bf16_plan``'s geometry, and the warp-specialised dx of
   ``csrc/sampled_dense_dx_bf16.cu``, on ``dx_bf16_plan``'s, also beside
   their earlier design, the partials one, rebuilt from
   ``scripts/comparison_kernels/sampled_dense_bf16_partials.cu`` with
   :data:`PARTIALS_BF16`, and beside the noise floor of their normals,
   :data:`NOISE_FLOOR_CU`; each plan printed), and the
   finite-difference adjoint of both precisions; the two bf16 parameter-
   gradient kernels through the public wrappers under the variable (counted
   under their bf16 names only) against their bf16 twins at the f32 gate,
   within the bf16 rounding bound of the f32 kernels and nearer the twin than
   a tenth of that distance, dbloc and dbrho bit-equal to the f32 kernel's,
   at model_7's three shapes (timed beside the earlier design, rebuilt: the
   wide ones the shared-sums design, :data:`SHARED_SUMS_DPARAMS_BF16`, the
   1024→10 head the partials design, :data:`NARROW_PARTIALS_DPARAMS_BF16`;
   and the noise floor; each plan printed) and the dparams edge shapes,
   bit-identical across calls;
   model_7's posterior
   gradient (``[param-grad]``'s setup) under the variable: exactly 1 fwd, 2
   xs_fwd, 2 xs_dx, 1 dparams and 2 xs_dparams bf16 launches and no f32
   one, 12 finite leaves apart from f32 and nearer the CPU's bf16 twins
   than 0.25 of that distance; model_7's fused FGSM and
   PGD through the CLI under the variable (the bf16 kernels launched as
   often as [main]'s f32 ones, no f32 attack kernel) and PGD in turns with
   f32; ``--bf16=True`` on model_0 (logits against f32 on the same draws,
   nonzero, and nearer the CPU's bf16 arithmetic; x_adv in its ball, PGD in
   turns, no sampled-dense launch); model_3's potential at batch 5,000 under
   HMC ``precision="default"`` against "high" (apart, and within bounds),
   its logits under the sampler's scope nearer the CPU's bf16 arithmetic,
   HMC evaluations/s of both in turns, a 2-draw NUTS run; TF32 still off
   after; then ``[attack-profile]``'s PGD under the variable (wall against
   device time an iteration);
   then ``[mesh]``, the mesh path at one NCCL rank, each stage bit-equal to
   the same call without a mesh: the attack CLI with ``--mesh=auto`` (x_adv
   and the launch counts of phase 7, NCCL's collective in the device trace
   of one PGD batch), an epoch of ``svi_train`` on ``model_7`` (60,000
   images), HMC and NUTS draws of ``model_3`` at batch 5,000 through
   ``BNN.train``, a 10-member fc2-1024 ensemble epoch and ``model_0``'s
   expected loss gradients at S = 10, each run without and with the mesh in
   turns; and the cost of the mesh at one rank, an SVI step and a PGD
   iteration, wall (in turns) and device time, with and without it; the
   default mesh and the group are taken down after;
8. training: ``model_7`` trained at full width for its 5 configured epochs on
   60,000 surrogate MNIST images through ``cli.train_bnn.run``, then
   attacked by PGD through the attack CLI from the saved posterior: a
   finite, falling loss, a posterior that moved and carries no
   ``requires_grad``, the same posterior loaded, and no dparams launch during
   the attack; then the wall and device time of 20 SVI steps (``torch.profiler``);
9. conv: ``model_0`` (MNIST conv-512) at B = 128, S = 10 seeded draws: the
   predictive's probabilities and input gradient within 1e-4·max of the same
   computation in float64 (TF32 would show near 1e-3), the stacked-draw
   ``apply``'s logits within 1e-5·max of a loop over the draws (both float64)
   and its f32 logits within 1e-4·max of float64, and the wall and device
   time of one forward plus input gradient;
   then ``[grouped-conv]``: the trunk's second-conv kernel
   (``csrc/grouped_conv.cu``) at model_0's attack shapes (B = 128, S = 100),
   its input channels-last (the trunk's) and NCHW, against float64 within
   (800 + 1)·2⁻²⁴ of each output's absolute sum of terms, bit-identical
   across calls, and its device time beside its bound, the plain version's
   and one ``F.conv2d`` call's, and its input gradient likewise (within
   (25·hidden + 1)·2⁻²⁴, dx with aten's strides, timed beside the plain
   twin, ``torch.nn.grad.conv2d_input`` and aten's input gradient in the
   trunk's layout) at S = 100, 10 and 1; then ``[grouped-conv3x3]``: ResNet-20's
   grouped 3×3 kernel (``csrc/grouped_conv3x3.cu``) at its five shapes (B =
   128, S = 100), forward and input gradient, against float64 within
   (K + 1)·2⁻²⁴ of each output's absolute sum of terms, bit-identical across
   calls, its device time beside its bound, the plain twin's and the
   library's (``F.conv2d``, ``torch.nn.grad.conv2d_input``); and
   ``[resnet20-attack]``: 40-step PGD at ε 8/255, S = 100 on 128 images of a
   seeded ``resnet20`` posterior, in the ε-ball and [0, 1], with 18 forward
   and 18 input-gradient launches of that kernel and one ``F.conv2d`` conv an
   iteration;
10. model_0 attack: Bayesian FGSM and 40-step PGD on a seeded random
   ``model_0`` posterior through the attack CLI (unfused: conv has no fused
   path), 256 images, S = 10: inside the ε-ball and [0, 1], at least 20% of
   pixels moved, no sampled-dense launch; then PGD's wall against device time;
11. north star (``scripts/northstar.py`` through the port): ``model_0``
   trained for its 5 epochs on 60,000 surrogate images at batch 128, the
   10-draw evaluation, PGD at S = 100 on 1,000 test images and the 500-draw
   defence evaluation: a finite, falling loss, a moved posterior with no
   ``requires_grad`` leaf, ``x_adv`` finite inside the ε-ball and [0, 1];
12. loss gradients: ``cli.loss_gradients`` on the trained posterior for
   S = 1, 10, 50, 100 on 1,000 test images: finite arrays of the input's shape;
13. HMC parity (``[hmc-parity]``): ``hmc_sample`` on an fc-64 BNN potential
   (Half Moons widths) with the same injected draws on the card and on the
   CPU (within 1e-4·max, every accept decision at least 1e-3 from its
   threshold), 20 dual-averaging updates on both, and one fc-64 leapfrog
   trajectory at MNIST widths against float64 (1e-5·max);
14. HMC training (``[hmc]``): ``cli.train_bnn --model_idx=3`` (Fashion-MNIST
   fc2-1024, 1,863,690 parameters) on the 60,000-image surrogate, faithful:
   12 batches of 5,000, warmup 50, 10 leapfrog steps, 100 draws: finite draws
   of that shape that all left the init, step sizes inside [1e-10, 1e3], a
   bit-equal reload; evaluations per second;
15. HMC profile (``[hmc-profile]``): one warmup transition at B = 5,000 with
   CUDA's sync debug mode set to error, wall against device-busy time, and one
   value-and-gradient evaluation against its bound;
16. HMC attack (``[hmc-attack]``): FGSM and 40-step PGD at S = 10 on the
   trained ``model_3`` through the attack CLI, 1,000 images: inside the
   ε-ball and [0, 1];
17. HMC loss gradients (``[hmc-loss-gradients]``): ``cli.loss_gradients
   --model_idx=3`` on 1,000 images, S = 1, 10, 50, 100: finite, the input's shape;
   each of phases 13-17 fails if a sampled-dense kernel launched in it;
18. NUTS parity (``[nuts-parity]``): one NUTS transition on the fc-64 BNN
   potential at the Half Moons widths (D = 322) at a fixed step, then a
   10-draw fixed-step chain, on the card and on the CPU with the same
   injected draws: every U-turn dot product, multinomial and merge
   comparison at least 1e-3 of its scale from its threshold (checked
   first), the same leaf counts and divergences, positions within 1e-4·max;
19. NUTS rate (``[nuts-rate]``): the JAX bench's saturated configuration,
   fc2-512 at MNIST widths (D = 669,706), 60,000 random inputs, 8 draws of
   max_depth 8 at a fixed step of 1e-5: exactly 255 leaves a draw and
   evaluations = leaves + 8; evaluations per second beside HMC's on the same
   potential, one evaluation against its bound, peak memory;
20. NUTS training (``[nuts]``): ``model_1`` (MNIST fc2-512) through
   ``BNN.train(hmc_sampler="nuts")`` on one faithful batch of 5,000
   surrogate images, cut to 2 draws after a warmup of 20 (the whole run's
   time): finite draws that all left the init, a step inside [1e-10, 1e3],
   a mean accept probability of at least 0.1, the 2-draw test evaluation,
   a bit-equal reload;
21. NUTS profile (``[nuts-profile]``): one draw at B = 5,000 from a trained
   draw at the trained step: at most one host read per leaf (the
   transition's own count and CUDA's sync debug mode), wall against
   device-busy time, one evaluation against its bound;
22. NN (``[nn]``): ``cli.train_nn --model_idx=0`` (MNIST conv-512, 5 epochs,
   batch 64) on 60,000 surrogate images: a finite, falling loss; then
   ``cli.attacks --model_type=nn``: FGSM and 40-step PGD on 1,000 images
   inside the ε-ball and [0, 1], ``--attack=False`` reloading the PGD attack
   bit-equal, and the deterministic expected loss gradient;
23. ensemble (``[ensemble]``): ``cli.train_ensemble --model_idx=0
   --ensemble_size=10`` (batch 100) on 60,000 images: a finite, falling mean
   member loss, members that differ, the stacked logit average within
   1e-5·max of a loop over members; ``cli.attacks --model_type=ensemble``:
   FGSM and PGD on 1,000 images inside the ε-ball and [0, 1]; the expected
   loss gradients over the 10 members;
   then two one-epoch trainings from one seed on 5,000 images give
   bit-equal stacked leaves;
   each of phases 18-23 fails if a sampled-dense kernel launched in it;
24. the paper's experiments through their CLIs' ``run``, each phase with its
   wall seconds and peak memory, each failing on a sampled-dense launch:
   ``[grid]`` one cell of the reference's Half Moons sweep (fc2-512, HMC
   faithful, 250 draws, warmup 100, 5,000 points; JAX's checkpoint name, a
   resuming rerun, gradients at S = 250, FGSM in the ε-ball, a transition
   profiled); ``[overparam]`` its 100 rows of 15 columns written and read
   back, the gradient columns equal to the saved gradients; ``[baseline]``
   ``model_7``'s NN, 100-member ensemble and SVI BNN: 7,000 rows, every
   attack in its ε-ball, the NN's and ensemble's first 64 rows within 1e-4
   of the CPU's; ``[eps]`` 1,500 rows, each attack in its own ε-ball;
   ``[gradients-components]`` S = 1, 10, 50, 100 on 1,000 images and the
   reload bit-equal; ``[multimodal]`` ``model_10`` uncut (three full-batch
   chains at 1,000, 10,000 and 60,000 points, 1,000 prior draws of D =
   669,706): 1,150 rows, the card's PCA of the prior within 1e-3 of max of
   numpy's float64 PCA with no sign flipped;
25. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` as the last line.
   ``launches`` counts the dparams kernels over phase 6, the bf16 dparams
   kernels over ``[precision]``'s model_7 posterior gradient, the other bf16
   kernels over its model_7 FGSM + PGD and the rest over phase 7.

Device-busy time (every idle share printed) is the union of the intervals
of the device events ``torch.profiler`` records.

Imports nothing of JAX. Writes only under a temporary directory and the
kernel build directory ``build/kernels``.
"""
from __future__ import annotations

import collections
import contextlib
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
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
ATTACK_KERNELS = ("sampled_dense_fwd", "sampled_dense_dx", "sampled_dense_xs_fwd", "sampled_dense_xs_dx")
BF16_ATTACK_KERNELS = tuple(f"{name}_bf16" for name in ATTACK_KERNELS)
BF16_DPARAMS = tuple(f"{name}_bf16" for name in DPARAMS)
# model_7's posterior gradient under ROBUSTBNNS_KERNEL_PRECISION=default: one
# launch a layer forward, the input gradients of the two upper layers (the
# input asks for none) and one parameter gradient a layer; no f32 kernel
BF16_PARAM_GRAD_LAUNCHES = {"sampled_dense_fwd_bf16": 1, "sampled_dense_xs_fwd_bf16": 2,
                            "sampled_dense_xs_dx_bf16": 2, "sampled_dense_dparams_bf16": 1,
                            "sampled_dense_xs_dparams_bf16": 2}


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


def profiled_device_ms(torch, fn, phase: str) -> tuple[float, float]:
    """Device-busy ms of ``fn`` under ``torch.profiler`` and the wall ms of
    that profiled call. Busy time is the union of the intervals of the device
    events (kernels, copies, fills) in the profiler's events: overlapping
    kernels count once, and nothing is counted twice through the host ops
    that launched it, so busy time cannot exceed the window. (A sum of
    ``self_device_time_total`` over ``key_averages()`` overran the wall for
    cuDNN-bound calls.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = wall_s(torch, fn)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
        if spans:
            break
        # A trace with no device event at all has been seen after several good
        # traces in one process: trace again, and say so.
        print(f"[{phase}] torch.profiler's trace {attempt + 1} held no device event; tracing again")
    busy_us, reach = 0.0, -math.inf
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    if busy_us <= 0:
        fail(f"[{phase}] torch.profiler saw no device time")
    return 1e-3 * busy_us, 1e3 * wall


def wall_s(torch, fn) -> float:
    """Host seconds of ``fn`` between two synchronisations with the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from robustbnns_tpu_torch.utils.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(flags):
        fail(f"[device] resolve_device('cuda') left TF32 on (matmul, cudnn) = {flags}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"resolve_device('cuda') alone turned TF32 off (matmul, cudnn) = {flags}")
    return smi


# The earlier (partials) design of the bf16 forward and input-gradient
# kernels, rebuilt beside the port's to time both in one process:
# scripts/comparison_kernels/sampled_dense_bf16_partials.cu keeps the
# templates (launch_fwd, launch_dx) and exports the summed dx
# (sampled_dense_dx_bf16_partials); these entry points, appended to a copy of
# it, export the forwards and the per-sample dx as that design ran them (a
# softplus pass, the runs' partial tiles and a second pass that sums them).
PARTIALS_BF16 = """
extern "C" int sampled_dense_fwd_bf16_partials(const float* x, const float* loc, const float* rho, const float* bloc,
                                               const float* brho, float* sp, float* partials, float* out, int S,
                                               int B, int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch_fwd<false>(x, loc, rho, bloc, brho, sp, partials, out, S, B, I, O, seed, n_split,
                                          static_cast<cudaStream_t>(stream));
}
extern "C" int sampled_dense_xs_fwd_bf16_partials(const float* xs, const float* loc, const float* rho,
                                                  const float* bloc, const float* brho, float* sp, float* partials,
                                                  float* out, int S, int B, int I, int O, uint32_t seed, int n_split,
                                                  void* stream) {
  return sampled_dense::launch_fwd<true>(xs, loc, rho, bloc, brho, sp, partials, out, S, B, I, O, seed, n_split,
                                         static_cast<cudaStream_t>(stream));
}
extern "C" int sampled_dense_xs_dx_bf16_partials(const float* g, const float* loc, const float* rho, float* sp,
                                                 float* partials, float* dxs, int S, int B, int I, int O, uint32_t seed,
                                                 int n_split, void* stream) {
  return sampled_dense::launch_dx<false>(g, loc, rho, sp, partials, dxs, S, B, I, O, seed, n_split,
                                         static_cast<cudaStream_t>(stream));
}
"""
# The noise floor of a call: its S·I·O normals drawn with the kernels'
# normal4, each thread folding the quads of ``rows`` rows of one column quad
# into one stored float (nothing read, so nothing is optimised away and
# nothing else is timed), with enough threads to fill the card.
NOISE_FLOOR_CU = """
#include "sampled_dense_common.cuh"
namespace {
__global__ void __launch_bounds__(256) noise_floor_kernel(float* __restrict__ out, uint32_t seed, int I, int quads,
                                                          int rows) {
  const int flat = blockIdx.x * 256 + threadIdx.x, q = flat % quads, i0 = flat / quads * rows;
  float fold = 0.f;
  for (int i = i0; i < min(I, i0 + rows); ++i) {
    const float4 z = sampled_dense::normal4(seed, blockIdx.y, i, q);
    fold += (z.x + z.y) + (z.z + z.w);
  }
  out[(size_t)blockIdx.y * gridDim.x * 256 + flat] = fold;
}
}
// out: S * ceil(ceil(O / 4) * ceil(I / rows) / 256) * 256 floats
extern "C" int noise_floor(float* out, int S, int I, int O, int rows, uint32_t seed, void* stream) {
  const int quads = (O + 3) / 4;
  const dim3 grid((quads * ((I + rows - 1) / rows) + 255) / 256, S);
  noise_floor_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, seed, I, quads, rows);
  return (int)cudaGetLastError();
}
"""
_extra_builds: dict = {}


def start_extra_build(name: str, text: str, workdir: str) -> None:
    """Compile ``text`` (a CUDA source that may include csrc's headers) with
    the port's nvcc flags into ``workdir``, in the background."""
    from robustbnns_tpu_torch.ops import build

    src, lib = os.path.join(workdir, f"{name}.cu"), os.path.join(workdir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    _extra_builds[name] = (lib, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def extra_library(name: str):
    """The library of :func:`start_extra_build`, waited for and loaded once."""
    import ctypes

    lib, proc = _extra_builds[name]
    if not isinstance(proc, ctypes.CDLL):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"[build] {name} failed:\n{out}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        _extra_builds[name] = (lib, ctypes.CDLL(lib))
    return _extra_builds[name][1]


# The earlier designs, rebuilt beside the port's to time both in one process:
# the partials design of the bf16 forwards and dx, the wide bf16
# parameter-gradient kernel with running sums in shared memory, and the narrow
# (O <= 16) one with partial planes.
COMPARISON_KERNELS = os.path.join(REPO, "scripts", "comparison_kernels")
PARTIALS_BF16_CU = os.path.join(COMPARISON_KERNELS, "sampled_dense_bf16_partials.cu")
SHARED_SUMS_DPARAMS_BF16 = os.path.join(COMPARISON_KERNELS, "sampled_dense_dparams_bf16_shared_sums.cu")
NARROW_PARTIALS_DPARAMS_BF16 = os.path.join(COMPARISON_KERNELS, "sampled_dense_dparams_bf16_narrow_partials.cu")


def start_comparison_builds(workdir: str) -> None:
    """The partials design's forwards and dx, the shared-sums design's wide
    dparams, the partials design's narrow dparams and the noise floor, for
    ``[precision]``."""
    for name, path, extra in (("partials_bf16", PARTIALS_BF16_CU, PARTIALS_BF16),
                              ("shared_sums_dparams_bf16", SHARED_SUMS_DPARAMS_BF16, ""),
                              ("narrow_partials_dparams_bf16", NARROW_PARTIALS_DPARAMS_BF16, "")):
        with open(path) as f:
            start_extra_build(name, f.read() + extra, workdir)
    start_extra_build("noise_floor", NOISE_FLOOR_CU, workdir)


def earlier_bf16(library: str, name: str):
    """The earlier design's entry point ``name`` of the comparison build
    ``library``, typed as the port's entry point it stands beside."""
    import ctypes

    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    fn = getattr(extra_library(library), name)
    port_name = name.removesuffix("_partials").removesuffix("_shared_sums")
    fn.argtypes, fn.restype = sd.SIGNATURES[port_name][1], ctypes.c_int
    return fn


def partials_bf16_call(torch, kind: str, a, params, n_samples: int, seed: int):
    """One call of the partials design's kernel of ``kind`` (``fwd``,
    ``xs_fwd``, ``dx``, ``xs_dx``) on its own plan (fwd_plan, dx_plan) and
    scratch, as its wrapper made it; ``params``: loc, rho and (the forwards)
    bloc, brho. Returns the output."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    b_dim = a.shape[-2]
    i_dim, o_dim = params[0].shape
    fwd = kind.endswith("fwd")
    plan = (sd.fwd_plan(n_samples, b_dim, i_dim, o_dim, sms) if fwd
            else sd.dx_plan(n_samples, b_dim, i_dim, o_dim, sms, kind == "dx"))
    out = torch.empty((n_samples, b_dim, o_dim) if fwd else (b_dim, i_dim) if kind == "dx"
                      else (n_samples, b_dim, i_dim), device=a.device)
    sp = torch.empty_like(params[1])
    partials = torch.empty(plan.scratch, device=a.device) if plan.scratch else None
    err = earlier_bf16("partials_bf16", f"sampled_dense_{kind}_bf16_partials")(
        a.data_ptr(), *(t.data_ptr() for t in params), sp.data_ptr(),
        partials.data_ptr() if partials is not None else None, out.data_ptr(), n_samples, b_dim, i_dim, o_dim, seed,
        plan.n_split, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the partials design's {kind}_bf16 kernel failed to launch: cudaError {err}")
    return out


def earlier_dparams_bf16_call(torch, kind: str, g, x, rho, brho, n_samples: int, seed: int):
    """One call of the earlier design of the bf16 dparams kernel of ``kind``
    (``dparams``, ``xs_dparams``) on dparams_plan, the plan it ran on: the
    shared-sums design where O > 16, the partials design of the narrow path
    (its partial planes and their pass) where O <= 16. Returns (dloc, drho,
    dbloc, dbrho)."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    (_, b_dim, o_dim), i_dim = g.shape, rho.shape[0]
    plan = sd.dparams_plan(n_samples, i_dim, o_dim, sms)
    outs = [torch.empty((i_dim, o_dim), device=g.device) for _ in range(2)] + \
        [torch.empty((o_dim,), device=g.device) for _ in range(2)]
    partials = torch.empty(plan.scratch, device=g.device) if plan.scratch else None
    library, suffix = ("narrow_partials_dparams_bf16", "partials") if plan.narrow else \
        ("shared_sums_dparams_bf16", "shared_sums")
    err = earlier_bf16(library, f"sampled_dense_{kind}_bf16_{suffix}")(
        g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr(),
        partials.data_ptr() if partials is not None else None, *(t.data_ptr() for t in outs), n_samples,
        b_dim, i_dim, o_dim, seed, plan.n_split, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the earlier design's {kind}_bf16 kernel failed to launch: cudaError {err}")
    return tuple(outs)


def noise_floor_ms(torch, n_samples: int, i_dim: int, o_dim: int) -> float:
    """Device ms of :data:`NOISE_FLOOR_CU` drawing the S·I·O normals of one
    call: at most 16 rows a thread, and at least 2,048 threads an SM."""
    import ctypes

    lib = extra_library("noise_floor")
    lib.noise_floor.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_void_p]
    lib.noise_floor.restype = ctypes.c_int
    quads = -(-o_dim // 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = max(1, min(16, n_samples * quads * i_dim // (2048 * sms)))
    out = torch.empty((n_samples * -(-quads * -(-i_dim // rows) // 256) * 256,), device="cuda")

    def run():
        err = lib.noise_floor(out.data_ptr(), n_samples, i_dim, o_dim, rows, 7,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"noise_floor failed to launch: cudaError {err}")

    return device_ms(torch, run)


def phase_build(workdir: str) -> None:
    from robustbnns_tpu_torch.ops import build

    t0 = time.perf_counter()
    start_comparison_builds(workdir)  # compiled beside the port's sources, waited for in [precision]
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


REF_B, REF_S = 128, 256  # [reference]: model_7's first layer (784 -> 1024) at the attack batch, 256 draws
# The moment gates of the JAX package's TPU test (tests/test_ops.py:55-59)
REF_MEAN_ABS, REF_STD_REL = 0.05, 0.05
# f32 kernel at zero scale against the reference: both are the dense layer
# x @ loc + bloc, f32 sums of 784 terms in orders that may differ, held to 1e-5 absolute on
# O(1) values, so to 1e-5 of the largest |entry| (about 13 here)
REF_ZERO_SCALE_OF_MAX = 1e-5


def noise_gate(what: str, eps) -> str:
    """N draws of eps against N(0, 1): the mean within 5/sqrt(N), the variance
    within 1 +- 5 sqrt(2/N), the share of |eps| > 3 within 5 sigma of
    P(|N(0, 1)| > 3); the numbers beside their limits."""
    e = eps.double()
    n = e.numel()
    mean, var, tail = float(e.mean()), float(e.var()), float((e.abs() > 3).double().mean())
    p = math.erfc(3 / math.sqrt(2))
    lims = (5 / math.sqrt(n), 5 * math.sqrt(2 / n), 5 * math.sqrt(p * (1 - p) / n))
    text = (f"{what}'s eps ({n} draws): mean {mean:.3e} (limit +-{lims[0]:.3e}), variance {var:.6f} "
            f"(limit 1 +- {lims[1]:.3e}), share beyond 3 {tail:.6f} (limit {p:.6f} +- {lims[2]:.3e})")
    if abs(mean) > lims[0] or abs(var - 1) > lims[1] or abs(tail - p) > lims[2]:
        fail(f"[reference] {text}")
    return text


def phase_reference(torch) -> None:
    """The four forward kernels (f32 and bf16 ``sampled_dense`` and
    ``sampled_dense_xs``, the latter on x broadcast over the draws) against
    ``sampled_dense_reference`` (``torch.randn`` draws from a CUDA generator)
    at model_7's first layer, B = 128, S = 256, inputs built as
    ``tests/test_ops.py:10-20`` builds them (rho, brho ~ N(0, 1) - 1):

    * moments: the global mean within 0.05 and the mean per-entry std across
      the draws within 5%, the JAX package's TPU gates;
    * zero scale (rho = brho = -1e4, softplus 0): the f32 kernels equal the
      reference within 1e-5 of the largest entry; the bf16 kernels equal the
      reference on bf16-rounded x and loc (the kernels' own rounding) within
      ``[precision]``'s gate for their twins;
    * the draws themselves, f32 kernels only: x = the first 128 one-hot rows
      and brho = -1e4 leave (out - loc[:128] - bloc) / softplus(rho[:128]) =
      eps, 33.5 M draws held to N(0, 1) by :func:`noise_gate`, and the
      reference's eps likewise as a control. The bf16 kernels round W_s to
      bf16, which inflates that variance, so they take the moment and
      zero-scale gates only.

    Each kernel must launch once a call (the launch counts' difference).
    """
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    from robustbnns_tpu_torch.utils.prng import key_from_seed

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("[reference] TF32 is on: the reference's products would round W to TF32")
    i_dim, o_dim = LAYERS[0]
    gen = torch.Generator(device="cuda").manual_seed(1236)
    normal = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, loc, rho = normal(REF_B, i_dim), normal(i_dim, o_dim) * 0.1, normal(i_dim, o_dim) - 1.0
    bloc, brho = normal(o_dim) * 0.1, normal(o_dim) - 1.0
    seed = 20261018

    def shared(a, *params):
        return sd.sampled_dense(a, *params, REF_S, seed)

    def per_sample(a, *params):
        return sd.sampled_dense_xs(a.expand(REF_S, *a.shape).contiguous(), *params, REF_S, seed)

    kernels = {  # name: (ROBUSTBNNS_KERNEL_PRECISION, call)
        "sampled_dense_fwd": (None, shared), "sampled_dense_xs_fwd": (None, per_sample),
        "sampled_dense_fwd_bf16": ("default", shared), "sampled_dense_xs_fwd_bf16": ("default", per_sample),
    }

    def launch(name, a, *params):
        precision, call = kernels[name]
        before = sd.launch_counts()
        with env_var("ROBUSTBNNS_KERNEL_PRECISION", precision):
            out = call(a, *params)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in sd.launch_counts().items() if v != before[k]}
        if moved != {name: 1}:
            fail(f"[reference] {name}: the call launched {moved}, not {name} once")
        if not bool(torch.isfinite(out).all()):
            fail(f"[reference] {name}: non-finite values")
        return out

    def reference(a, *params, key=9):
        return sd.sampled_dense_reference(a, *params, REF_S, key_from_seed(key, "cuda"))

    ref = reference(x, loc, rho, bloc, brho)
    ref_mean, ref_std = float(ref.mean()), float(ref.std(0).mean())
    del ref
    neg, negb = torch.full_like(rho, -1e4), torch.full_like(brho, -1e4)
    dense = reference(x, loc, neg, bloc, negb)
    x16, loc16 = sd._bf16(x), sd._bf16(loc)
    dense16 = reference(x16, loc16, neg, bloc, negb)
    # [precision]'s twin gate; at zero scale every W_s is loc, so one draw gives the largest term
    term = sd.bf16_error_scale("fwd", x, loc, neg, 1, seed, largest=True)
    gate16 = BF16_FLIP_OF_TERM * term + RTOL * dense16.abs() + ATOL_OF_MAX * float(dense16.abs().max())
    atol = REF_ZERO_SCALE_OF_MAX * max(1.0, float(dense.abs().max()))
    one_hot = torch.eye(i_dim, device="cuda")[:REF_B].contiguous()
    sharp = (loc[:REF_B], sd.softplus(rho[:REF_B]))

    def eps_of(out):
        return (out - sharp[0] - bloc) / sharp[1]

    control = eps_of(reference(one_hot, loc, rho, bloc, negb, key=10))
    print(f"[reference] {noise_gate('sampled_dense_reference', control)}")
    del control
    for name, (precision, _) in kernels.items():
        out = launch(name, x, loc, rho, bloc, brho)
        mean, std = float(out.mean()), float(out.std(0).mean())
        del out
        if abs(mean - ref_mean) > REF_MEAN_ABS or abs(std - ref_std) > REF_STD_REL * ref_std:
            fail(f"[reference] {name}: global mean {mean:.5f} against the reference's {ref_mean:.5f} (limit "
                 f"{REF_MEAN_ABS}), mean per-entry std {std:.5f} against {ref_std:.5f} (limit {REF_STD_REL:.0%})")
        text = (f"[reference] {name} B={REF_B} S={REF_S} I={i_dim} O={o_dim}: global mean {mean:.5f} against the "
                f"reference's {ref_mean:.5f} (|diff| {abs(mean - ref_mean):.2e}, limit {REF_MEAN_ABS}); mean per-entry "
                f"std {std:.5f} against {ref_std:.5f} (rel diff {abs(std - ref_std) / ref_std:.2e}, limit "
                f"{REF_STD_REL})")
        zero = launch(name, x, loc, neg, bloc, negb)
        if precision is None:
            err = float((zero - dense).abs().max())
            if err > atol:
                fail(f"[reference] {name} at zero scale: max|err| {err:.3e} from the reference, limit {atol:.3e}")
            text += f"; zero scale max|err| {err:.3e} (limit {atol:.3e}); " + noise_gate(
                name, eps_of(launch(name, one_hot, loc, rho, bloc, negb)))
        else:
            diff = (zero - dense16).abs()
            share = float((diff / gate16).max())
            if share > 1:
                fail(f"[reference] {name} at zero scale: max|err| {float(diff.max()):.3e} from the reference on "
                     f"bf16-rounded x and loc, {share:.3f} of [precision]'s twin gate")
            text += (f"; zero scale max|err| {float(diff.max()):.3e} from the reference on bf16-rounded x and loc "
                     f"(at most {share:.3f} of [precision]'s twin gate)")
        del zero
        print(text)
    del dense, dense16
    torch.cuda.empty_cache()
    print(f"[reference] phase {time.perf_counter() - t0:.3f} s wall")


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


def seeded_posterior(torch, arch, rel_scale: float = 1e-2, rho_spread: float = 0.0):
    """A seeded random posterior at an architecture's widths: loc from the
    torch-default init, softplus(rho) = ``rel_scale`` of each layer's init
    bound 1/sqrt(fan_in), rho spread by ``rho_spread``·N(0, 1). The
    reference's N(0, 1) init (``init_meanfield``) saturates the softmax of an
    untrained fc2-1024 or conv-512, and the attack gradients then vanish."""
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
    post = seeded_posterior(torch, arch)
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
    post = seeded_posterior(torch, arch, rel_scale=0.5, rho_spread=0.3)
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


def check_attack_launches(phase: str, counts: dict, kernels=ATTACK_KERNELS) -> None:
    """An attack runs the four forward and dx ``kernels`` (f32, or their bf16
    variants), no dparams kernel of either precision and no kernel of the
    other precision."""
    if not all(counts[name] > 0 for name in kernels):
        fail(f"[{phase}] a kernel of the attack never launched: {counts}")
    if any(counts[name] for name in DPARAMS + BF16_DPARAMS):
        fail(f"[{phase}] the attack launched a parameter-gradient kernel: {counts}")
    if any(n for name, n in counts.items() if name not in kernels and name not in DPARAMS + BF16_DPARAMS):
        fail(f"[{phase}] the attack launched a kernel of the other precision: {counts}")


def phase_main_path(torch, workdir: str) -> dict:
    """FGSM and PGD on model_7 through the attack CLI, fused, counting launches."""
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.config import DATA, saved_BNNs
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts

    if not os.path.abspath(DATA).startswith(workdir):
        fail(f"ROBUSTBNNS_DATA was not redirected to the temporary directory ({DATA})")
    bnn = BNN.from_config(saved_BNNs["model_7"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = seeded_posterior(torch, bnn.arch)
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
    return counts, runs


def phase_attack_profile(torch, phase: str = "attack-profile", what: str = "PGD") -> None:
    """Wall clock and device time of 40-step PGD at model_7's widths, as the
    CLI runs it (256 images in batches of 128, S = 10, fused): the median
    wall time of three unprofiled attacks, and the device time of their
    kernels under ``torch.profiler`` in a fourth."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.models.bnn import BNN

    bnn = BNN.from_config(saved_BNNs["model_7"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = seeded_posterior(torch, bnn.arch)
    gen = torch.Generator(device="cuda").manual_seed(13)
    n, iters = 2 * B, 2 * 40
    x = torch.rand((n, 28, 28, 1), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (n,), generator=gen, device="cuda"), 10).float()
    run = lambda: attack(bnn, x, y, method="pgd", n_samples=S, fused=True, save=False, verbose=False)  # noqa: E731
    print_pgd_profile(torch, phase, what, run, n, iters)


def print_pgd_profile(torch, phase: str, what: str, run, n: int, iters: int) -> None:
    """The median wall time of three unprofiled attacks against the device
    time of a fourth's kernels, per PGD iteration."""
    run()
    walls = [wall_s(torch, run) for _ in range(3)]
    wall = statistics.median(walls)
    dev_ms, prof_ms = profiled_device_ms(torch, run, phase)
    it_ms, dev_ms, prof_ms = 1e3 * wall / iters, dev_ms / iters, prof_ms / iters
    print(f"[{phase}] {what}, 40 steps on {n} images, S={S}: {n / wall:.1f} images/s (median of "
          f"{[round(n / w, 1) for w in walls]}); an iteration {it_ms:.3f} ms wall, {dev_ms:.3f} ms of "
          f"device kernels (device idle {100 * (1 - dev_ms / it_ms):.1f}% of the iteration; under the "
          f"profiler {prof_ms:.3f} ms wall, idle {100 * (1 - dev_ms / prof_ms):.1f}%)")


# The bf16 opt-ins (ROBUSTBNNS_KERNEL_PRECISION=default, ROBUSTBNNS_BF16=1 and
# --bf16, MCMC precision="default"). The bf16 kernels multiply the same bf16
# operands as their twins, exactly in f32, summed in another order: each
# output within the f32 gate of its twin, plus 2^-7 of its largest single
# term |x_i||W_si|, for a W_s that the kernel and torch round an ulp apart in
# f32 and that lands on the other bf16 neighbour. Against the exact f32
# kernel, rounding both operands (unit roundoff 2^-8) moves an output by at
# most 2·2^-8·Σ|x||W_s|, on top of the f32 gate. Either gate alone would pass
# a kernel that skipped the rounding, so each kernel must also sit nearer its
# bf16 twin than a tenth of its distance from the f32 kernel.
BF16_FLIP_OF_TERM, BF16_F32_OF_SCALE, BF16_NEARER = 2.0**-7, 2 * 2.0**-8, 0.1
BF16_ADJOINT_GATE = 2.0**-5  # the bf16 dx is not the exact adjoint of the rounded forward
# ROBUSTBNNS_BF16 against f32 on the same draws: a chain of bf16 products
# (conv outputs rounded to bf16 too) moves model_0's logits by about 5e-3 of
# their largest entry (a CPU run of the port at conv-512), model_3's potential
# by about 2e-6 relative and its gradient by about 7e-3 of its largest entry.
# The card's bf16 logits must also sit nearer the port's CPU arithmetic
# (bf16-rounded operands multiplied in f32, held to JAX by the CPU tests) than
# BF16_MODEL_NEARER of their distance from f32 (root sums of squares over the
# logits): any other arithmetic (f32, TF32) sits at about 1. Not 0.1: a
# hidden value that two summation orders put an f32 ulp apart and round to
# the other bf16 neighbour is rounded again in the next layer, and with
# nothing but the batch split changed the port's own CPU runs at fc2-1024
# part by up to 0.072 of that distance.
BF16_LOGITS_OF_MAX, BF16_U_REL, BF16_GRAD_OF_MAX = 2.0**-5, 1e-4, 2.0**-5
BF16_MODEL_NEARER = 0.25
BF16_EMULATED_IMAGES = 16  # images of the CPU comparison
PRECISION_HMC_IMAGES = 5000


@contextlib.contextmanager
def env_var(name: str, value):
    """``os.environ[name] = value`` (unset for None) inside the block, restored after."""
    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def phase_precision_kernels(torch) -> dict:
    """Each bf16 kernel against its bf16 twin and the exact f32 kernel, at
    model_7's shapes and the edge shapes, bit-identical across calls; times of
    kernel, twin, one library call and the f32 kernel in this process; the
    finite-difference adjoint of both precisions."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

    gen = torch.Generator(device="cuda").manual_seed(1235)
    seed = 20261017
    pallas = "robustbnns_tpu/ops/sampled_dense.py"
    sources = {kind: f"robustbnns_tpu_torch/csrc/sampled_dense_{'dx_' if kind == 'dx' else 'xs_'}bf16.cu"
               for kind in ("fwd", "dx", "xs_fwd", "xs_dx")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kinds = {  # kind: (bf16 wrapper, bf16 twin, f32 wrapper, Pallas line, shared input)
        "fwd": (sd.sampled_dense_fwd_bf16, sd.sampled_dense_fwd_bf16_plain, sd.sampled_dense_fwd, 99, True),
        "dx": (sd.sampled_dense_dx_bf16, sd.sampled_dense_dx_bf16_plain, sd.sampled_dense_dx, 114, True),
        "xs_fwd": (sd.sampled_dense_xs_fwd_bf16, sd.sampled_dense_xs_fwd_bf16_plain, sd.sampled_dense_xs_fwd, 347,
                   False),
        "xs_dx": (sd.sampled_dense_xs_dx_bf16, sd.sampled_dense_xs_dx_bf16_plain, sd.sampled_dense_xs_dx, 362, False),
    }
    results, got_ref = {}, {}  # got_ref: the last checked call of each kind, and its bf16 twin

    def inputs(kind, b_dim, i_dim, o_dim, n_samples):
        loc, rho, bloc, brho = _layer_inputs(torch, gen, i_dim, o_dim)
        if kind == "fwd":
            a = torch.rand((b_dim, i_dim), generator=gen, device="cuda")
        elif kind == "xs_fwd":
            a = torch.nn.functional.leaky_relu(torch.randn((n_samples, b_dim, i_dim), generator=gen, device="cuda"),
                                               0.01)
        else:
            a = torch.randn((n_samples, b_dim, o_dim), generator=gen, device="cuda")
        rest = (loc, rho, bloc, brho) if kind.endswith("fwd") else (loc, rho)
        return a, rest

    def check(kind, shape_text, a, rest, n_samples):
        kernel, twin, f32_kernel, _, _ = kinds[kind]
        got, again = kernel(a, *rest, n_samples, seed), kernel(a, *rest, n_samples, seed)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"[precision] {kind}_bf16 {shape_text}: two calls differ")
        if not bool(torch.isfinite(got).all()):
            fail(f"[precision] {kind}_bf16 {shape_text}: non-finite values")
        ref, f32 = twin(a, *rest, n_samples, seed), f32_kernel(a, *rest, n_samples, seed)
        scale = sd.bf16_error_scale(kind, a, rest[0], rest[1], n_samples, seed)
        term = sd.bf16_error_scale(kind, a, rest[0], rest[1], n_samples, seed, largest=True)
        err, err32 = (got - ref).abs(), (got - f32).abs()
        twin_gate = BF16_FLIP_OF_TERM * term + RTOL * ref.abs() + ATOL_OF_MAX * float(ref.abs().max())
        if not bool((err <= twin_gate).all()):
            fail(f"[precision] {kind}_bf16 {shape_text}: kernel disagrees with its bf16 twin (max |err| "
                 f"{float(err.max()):.3e}, worst share of its gate {float((err / twin_gate).max()):.3f})")
        f32_gate = BF16_F32_OF_SCALE * scale + RTOL * f32.abs() + ATOL_OF_MAX * float(f32.abs().max())
        if not bool((err32 <= f32_gate).all()):
            fail(f"[precision] {kind}_bf16 {shape_text}: {float(err32.max()):.3e} from the f32 kernel, beyond the "
                 f"bf16 rounding bound")
        nearer = float(err.max()) / float(err32.max())
        if not nearer < BF16_NEARER:
            fail(f"[precision] {kind}_bf16 {shape_text}: {float(err.max()):.3e} from its bf16 twin against "
                 f"{float(err32.max()):.3e} from the f32 kernel (ratio {nearer:.3e}, gate {BF16_NEARER}): "
                 f"not the bf16 arithmetic")
        got_ref[kind] = (got, ref)
        return float(err.max()), float((err32 / scale).max()) / 2.0**-8, nearer

    for li, (i_dim, o_dim) in enumerate(LAYERS):  # the main path's shapes, timed
        for kind in (("fwd", "dx") if li == 0 else ("xs_fwd", "xs_dx")):
            kernel, twin, f32_kernel, line, _ = kinds[kind]
            a, rest = inputs(kind, B, i_dim, o_dim, S)
            shape = f"B={B} S={S} I={i_dim} O={o_dim}"
            err, share, nearer = check(kind, shape, a, rest, S)
            w = sd._sampled_w(rest[0], rest[1], S, seed).to(torch.bfloat16)
            a16 = a.to(torch.bfloat16)
            if kind == "fwd":
                lib = lambda: torch.bmm(a16.expand(S, B, i_dim), w, out_dtype=torch.float32)  # noqa: E731
            elif kind == "xs_fwd":
                lib = lambda: torch.bmm(a16, w, out_dtype=torch.float32)  # noqa: E731
            elif kind == "dx":  # Σ_s g_s W_sᵀ as one product over (s, o)
                g_cat = a16.permute(1, 0, 2).reshape(B, S * o_dim)
                w_cat = w.permute(0, 2, 1).reshape(S * o_dim, i_dim)
                lib = lambda: torch.mm(g_cat, w_cat, out_dtype=torch.float32)  # noqa: E731
            else:
                lib = lambda: torch.bmm(a16, w.transpose(1, 2), out_dtype=torch.float32)  # noqa: E731
            run = lambda: kernel(a, *rest, S, seed)  # noqa: E731
            c_ms = call_ms(torch, run)
            ms, plain_ms, lib_ms = device_ms(torch, run), device_ms(torch, lambda: twin(a, *rest, S, seed)), \
                device_ms(torch, lib)
            f32_ms = device_ms(torch, lambda: f32_kernel(a, *rest, S, seed))
            flops = 2.0 * S * B * i_dim * o_dim
            out_numel = (B * i_dim if kind == "dx" else S * B * (o_dim if kind.endswith("fwd") else i_dim))
            nbytes = 4.0 * (a.numel() + 2 * i_dim * o_dim + (2 * o_dim if kind.endswith("fwd") else 0) + out_numel)
            b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            name = f"sampled_dense_{kind}_bf16"
            # the redesigned kernels: the partials design and the noise floor beside them
            before = lambda: partials_bf16_call(torch, kind, a, rest, S, seed)  # noqa: E731
            before_err = float((before() - got_ref[kind][1]).abs().max())
            extra = {"before_ms": device_ms(torch, before), "before_call_ms": call_ms(torch, before),
                     "noise_floor_ms": noise_floor_ms(torch, S, i_dim, o_dim)}
            if kind == "dx":
                plan = sd.dx_bf16_plan(S, B, i_dim, o_dim, sms)
                plan_text = (f"dx_bf16_plan on {sms} SMs: n_split {plan.n_split} in clusters of {plan.cluster} "
                             f"({plan.n_split // plan.cluster} a tile, partials {plan.scratch or 'none'}), grid "
                             f"{plan.grid}, {plan.depth}-deep units x {plan.units} a tile")
            else:
                plan = sd.xs_bf16_plan(S, B, i_dim, o_dim, sms, kind.removeprefix("xs_"))
                plan_text = (f"xs_bf16_plan on {sms} SMs: n_split {plan.n_split}, grid {plan.grid}, {plan.cols}-column "
                             f"tiles, {plan.depth}-deep chunks x {plan.chunks}, softplus scratch "
                             f"{plan.softplus_scratch}")
            print(f"[precision] {name} {shape}: {plan_text}; the partials design (rebuilt) "
                  f"{extra['before_ms']:.4f} ms (call {extra['before_call_ms']:.4f} ms; max|err| from the bf16 "
                  f"twin {before_err:.3e}; x{extra['before_ms'] / ms:.2f} the kernel's time), the noise floor "
                  f"of its {S * i_dim * o_dim} normals {extra['noise_floor_ms']:.4f} ms")
            print(f"[precision] {name} {shape}: max|err| {err:.3e} from its bf16 twin ({nearer:.2e} of its max "
                  f"distance from the f32 kernel, gate {BF16_NEARER}); from the f32 kernel at most {share:.3f} of "
                  f"2^-8 sum|x||W| (gate 2); kernel {ms:.4f} ms (call {c_ms:.4f} ms), f32 kernel "
                  f"{f32_ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, {100 * b_ms / ms:.1f}% of the kernel)")
            r = results.setdefault(name, {
                "name": name, "route": "cuda", "source": sources[kind], "replaces": f"{pallas}:{line}",
                "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "flops": 0.0, "bytes": 0.0, "library_ms": 0.0, "f32_ms": 0.0, "peak_flops": PEAK_BF16_FLOPS,
                "per_shape": [],
            })
            r["max_abs_err"] = max(r["max_abs_err"], err)
            for key, v in (("ms", ms), ("call_ms", c_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", b_ms), ("flops", flops), ("bytes", nbytes), ("f32_ms", f32_ms)):
                r[key] += v
            r["per_shape"].append({"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "f32_ms": f32_ms,
                                   "max_abs_err": err, **extra})
    for kinds_here, shapes in ((("fwd", "xs_fwd"), FWD_EDGE_SHAPES), (("dx", "xs_dx"), DX_EDGE_SHAPES)):
        for b_dim, i_dim, o_dim, n_samples in shapes:
            errs = []
            for kind in kinds_here:
                a, rest = inputs(kind, b_dim, i_dim, o_dim, n_samples)
                errs.append(check(kind, f"B={b_dim} I={i_dim} O={o_dim} S={n_samples}", a, rest, n_samples))
            print(f"[precision] edge B={b_dim} I={i_dim} O={o_dim} S={n_samples}: max|err| from the bf16 twins "
                  f"{kinds_here[0]} {errs[0][0]:.3e}, {kinds_here[1]} {errs[1][0]:.3e} ({errs[0][2]:.2e} and "
                  f"{errs[1][2]:.2e} of the distance from the f32 kernel); bit-identical repeats")

    # ⟨dx, v⟩ against ⟨g, (f(x + hv) − f(x − hv)) / 2h⟩ at model_7's first layer
    i_dim, o_dim = LAYERS[0]
    x, (loc, rho, bloc, brho) = inputs("fwd", B, i_dim, o_dim, S)
    v = torch.randn(x.shape, generator=gen, device="cuda")
    g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
    h, adjoint = 0.25, {}
    for label, fwd, dx in (("f32", sd.sampled_dense_fwd, sd.sampled_dense_dx),
                           ("bf16", sd.sampled_dense_fwd_bf16, sd.sampled_dense_dx_bf16)):
        f = lambda a: fwd(a, loc, rho, bloc, brho, S, seed).double()  # noqa: E731
        fd = float((g.double() * (f(x + h * v) - f(x - h * v))).sum()) / (2 * h)
        ad = float((dx(g, loc, rho, S, seed).double() * v.double()).sum())
        adjoint[label] = abs(ad - fd) / abs(fd)
    if not (math.isfinite(adjoint["bf16"]) and adjoint["bf16"] < BF16_ADJOINT_GATE):
        fail(f"[precision] the bf16 dx is {adjoint['bf16']:.3e} from the finite-difference adjoint "
             f"(gate {BF16_ADJOINT_GATE:.3e})")
    print(f"[precision] finite-difference adjoint at {B}x{i_dim}->{o_dim}, S={S}, h={h}: |<dx, v> - <g, fd>| / "
          f"|<g, fd>| f32 {adjoint['f32']:.3e}, bf16 {adjoint['bf16']:.3e} (gate {BF16_ADJOINT_GATE:.3e})")
    torch.cuda.synchronize()
    return results


def phase_precision_dparams(torch) -> dict:
    """The two bf16 parameter-gradient kernels through their public wrappers
    under ROBUSTBNNS_KERNEL_PRECISION=default, counted under their bf16 names
    only: against their bf16 twins at the f32 gate (no W_s is rounded, so
    kernel and twin form the same exact products and sum them in another
    order), against the f32 kernels (the bf16 rounding bound), dloc and drho
    nearer the twin than BF16_NEARER of their distance from the f32 kernel,
    dbloc and dbrho bit-equal to the f32 kernel's, bit-identical across calls;
    at model_7's three shapes, timed beside the twin, one cuBLAS bf16 product
    and the f32 kernel (the wide shapes also beside the earlier shared-sums
    design, rebuilt, and the noise floor), and at the dparams edge shapes."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    gen = torch.Generator(device="cuda").manual_seed(1236)
    seed = 20261018
    src, pallas = "robustbnns_tpu_torch/csrc/sampled_dense_dparams_bf16.cu", "robustbnns_tpu/ops/sampled_dense.py"
    kinds = {  # kind: (public wrapper, bf16 wrapper, Pallas line)
        "dparams": (sd.sampled_dense_dparams, sd.sampled_dense_dparams_bf16, 137),
        "xs_dparams": (sd.sampled_dense_xs_dparams, sd.sampled_dense_xs_dparams_bf16, 383),
    }
    results = {}

    def inputs(kind, b_dim, i_dim, o_dim, n_samples):
        _, rho, _, brho = _layer_inputs(torch, gen, i_dim, o_dim)
        g = torch.randn((n_samples, b_dim, o_dim), generator=gen, device="cuda")
        if kind == "dparams":
            x = torch.rand((b_dim, i_dim), generator=gen, device="cuda")
        else:
            x = torch.nn.functional.leaky_relu(torch.randn((n_samples, b_dim, i_dim), generator=gen, device="cuda"),
                                               0.01)
        return g, x, rho, brho, n_samples, seed

    def check(kind, shape_text, args):
        public, kernel, _ = kinds[kind]
        name = kernel.__name__
        with env_var("ROBUSTBNNS_KERNEL_PRECISION", "default"):
            before = sd.launch_counts()
            got, again = public(*args), public(*args)
            torch.cuda.synchronize()
            after = sd.launch_counts()
            counted = tuple(after[w.__name__] - before[w.__name__] for w in (kernel, public))
        if counted != (2, 0):
            fail(f"[precision] {name} {shape_text}: two calls under the variable counted {counted[0]} bf16 and "
                 f"{counted[1]} f32 launches")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"[precision] {name} {shape_text}: two calls differ")
        if not all(bool(torch.isfinite(a).all()) for a in got):
            fail(f"[precision] {name} {shape_text}: non-finite values")
        twin, f32 = sd.sampled_dense_dparams_bf16_plain(*args), public(*args)  # unset: the f32 kernel
        scales = sd.bf16_error_scale(kind, *args[:3], *args[4:])
        errs, shares, nearers = [], [], []
        for k, (got_k, ref_k, f32_k) in enumerate(zip(got, twin, f32)):
            errs.append(check_close(f"[precision] {name} {shape_text} output {k}", got_k, ref_k, RTOL,
                                    ATOL_OF_MAX * float(ref_k.abs().max())))
            if k >= 2:  # the bias takes no product: f32 in both precisions
                continue
            err32 = (got_k - f32_k).abs()
            f32_gate = BF16_F32_OF_SCALE * scales[k] + RTOL * f32_k.abs() + ATOL_OF_MAX * float(f32_k.abs().max())
            if not bool((err32 <= f32_gate).all()):
                fail(f"[precision] {name} {shape_text} output {k}: {float(err32.max()):.3e} from the f32 kernel, "
                     f"beyond the bf16 rounding bound")
            nearer = errs[-1] / float(err32.max())
            if not nearer < BF16_NEARER:
                fail(f"[precision] {name} {shape_text} output {k}: {errs[-1]:.3e} from its bf16 twin against "
                     f"{float(err32.max()):.3e} from the f32 kernel (ratio {nearer:.3e}, gate {BF16_NEARER}): "
                     f"not the bf16 arithmetic")
            shares.append(float((err32 / scales[k].clamp_min(1e-30)).max()) / 2.0**-8)
            nearers.append(nearer)
        same_bias = all(torch.equal(a, c) for a, c in zip(got[2:], f32[2:]))
        if not same_bias:
            fail(f"[precision] {name} {shape_text}: dbloc or dbrho not bit-equal to the f32 kernel's")
        return max(errs), max(shares), max(nearers), same_bias

    for li, (i_dim, o_dim) in enumerate(LAYERS):  # the main path's shapes, timed
        kind = "dparams" if li == 0 else "xs_dparams"
        public, kernel, line = kinds[kind]
        args = inputs(kind, B, i_dim, o_dim, S)
        shape = f"B={B} S={S} I={i_dim} O={o_dim}"
        err, share, nearer, same_bias = check(kind, shape, args)
        g, x = args[0], args[1]
        g16, x16 = g.to(torch.bfloat16), x.to(torch.bfloat16)
        xt16 = x16.t().expand(S, i_dim, B) if kind == "dparams" else x16.transpose(1, 2)
        lib = lambda: torch.bmm(xt16, g16, out_dtype=torch.float32)  # noqa: E731  (the S dW_s, no epilogue)
        run = lambda: kernel(*args)  # noqa: E731
        c_ms = call_ms(torch, run)
        ms, plain_ms = device_ms(torch, run), device_ms(torch, lambda: sd.sampled_dense_dparams_bf16_plain(*args))
        lib_ms, f32_ms = device_ms(torch, lib), device_ms(torch, lambda: public(*args))
        flops = 2.0 * S * B * i_dim * o_dim
        nbytes = 4.0 * (S * B * o_dim + x.numel() + 3 * i_dim * o_dim + 3 * o_dim)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        name = kernel.__name__
        # the redesigned kernels: the earlier design (shared sums; the head's partial
        # planes) and the noise floor beside them
        before = lambda: earlier_dparams_bf16_call(torch, kind, *args)  # noqa: E731
        ref = sd.sampled_dense_dparams_bf16_plain(*args)
        before_err = max(float((a - c).abs().max()) for a, c in zip(before(), ref))
        extra = {"before_ms": device_ms(torch, before), "before_call_ms": call_ms(torch, before),
                 "noise_floor_ms": noise_floor_ms(torch, S, i_dim, o_dim)}
        plan = sd.dparams_bf16_plan(S, B, i_dim, o_dim, sms)
        print(f"[precision] {name} {shape}: dparams_bf16_plan on {sms} SMs: {'head, ' if plan.narrow else ''}"
              f"n_split {plan.n_split} in clusters of {plan.ranks}, grid {plan.grid}, {plan.chunks} chunks a "
              f"sample; the {'partials' if plan.narrow else 'shared-sums'} design (rebuilt) "
              f"{extra['before_ms']:.4f} ms (call {extra['before_call_ms']:.4f} ms; max|err| from the bf16 "
              f"twin {before_err:.3e}; x{extra['before_ms'] / ms:.2f} the kernel's time), the noise floor of "
              f"its {S * i_dim * o_dim} normals {extra['noise_floor_ms']:.4f} ms")
        print(f"[precision] {name} {shape}: max|err| {err:.3e} from its bf16 twin ({nearer:.2e} of the max "
              f"distance of dloc or drho from the f32 kernel, gate {BF16_NEARER}); from the f32 kernel at most "
              f"{share:.3f} of 2^-8 sum|x||g| (gate 2); dbloc and dbrho bit-equal to the f32 kernel's: "
              f"{same_bias}; kernel {ms:.4f} ms (call {c_ms:.4f} ms), f32 kernel "
              f"{f32_ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {100 * b_ms / ms:.1f}% of the kernel)")
        r = results.setdefault(name, {
            "name": name, "route": "cuda", "source": src, "replaces": f"{pallas}:{line}",
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "flops": 0.0, "bytes": 0.0, "library_ms": 0.0, "f32_ms": 0.0, "peak_flops": PEAK_BF16_FLOPS,
            "per_shape": [],
        })
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, v in (("ms", ms), ("call_ms", c_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", b_ms), ("flops", flops), ("bytes", nbytes), ("f32_ms", f32_ms)):
            r[key] += v
        r["per_shape"].append({"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "f32_ms": f32_ms,
                               "max_abs_err": err, "bias_bit_equal_to_f32": same_bias, **extra})
    for b_dim, i_dim, o_dim, n_samples in DPARAMS_EDGE_SHAPES:
        shape = f"B={b_dim} I={i_dim} O={o_dim} S={n_samples}"
        errs = [check(kind, shape, inputs(kind, b_dim, i_dim, o_dim, n_samples)) for kind in kinds]
        print(f"[precision] edge {shape}: max|err| from the bf16 twins dparams {errs[0][0]:.3e}, xs_dparams "
              f"{errs[1][0]:.3e} ({errs[0][2]:.2e} and {errs[1][2]:.2e} of the distance from the f32 kernel); "
              f"bit-identical repeats")
    torch.cuda.synchronize()
    return results


def phase_precision_param_grad(torch) -> dict:
    """model_7's posterior gradient under ROBUSTBNNS_KERNEL_PRECISION=default
    on ``[param-grad]``'s setup (B = 128, S = 10): the gradient of the fused
    predictive's cross-entropy in all 12 leaves launches exactly
    :data:`BF16_PARAM_GRAD_LAUNCHES` and no f32 kernel; 12 finite leaves,
    each apart from the f32 gradient; and nearer the port's CPU bf16
    arithmetic (the same inputs on the CPU, through the bf16 twins) than
    :data:`BF16_MODEL_NEARER` of its distance from the f32 gradient, by root
    sums of squares over the leaves. Returns the bf16 gradient's launches."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.ops.fused_predict import svi_predict_fused
    from robustbnns_tpu_torch.utils.pytree import tree_leaves
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "mnist")
    post = seeded_posterior(torch, arch, rel_scale=0.5, rho_spread=0.3)
    seed = 4242
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((B, 28, 28, 1), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda")

    def grads(p, inp, lab):
        leaves = type(p)(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in tree)
                           for tree in p))
        flat = tree_leaves(leaves.loc) + tree_leaves(leaves.rho)
        return torch.autograd.grad(ce_on_outputs(svi_predict_fused(arch, leaves, inp, S, seed), lab).sum(), flat)

    with env_var("ROBUSTBNNS_KERNEL_PRECISION", "default"):
        sd.reset_launch_counts()
        low = grads(post, x, labels)
        torch.cuda.synchronize()
        counts = sd.launch_counts()
        t0 = time.perf_counter()
        cpu = grads(type(post)(*(tuple({k: v.cpu() for k, v in layer.items()} for layer in tree) for tree in post)),
                    x.cpu(), labels.cpu())
        cpu_s = time.perf_counter() - t0
    exact = grads(post, x, labels)
    print(f"[precision] model_7 posterior gradient under ROBUSTBNNS_KERNEL_PRECISION=default: launches "
          f"{json.dumps(counts)}")
    if counts != {name: BF16_PARAM_GRAD_LAUNCHES.get(name, 0) for name in counts}:
        fail(f"[precision] the bf16 posterior gradient launched {counts}, not {BF16_PARAM_GRAD_LAUNCHES} alone")
    names = [f"{t}/{li}/{k}" for t in ("loc", "rho") for li in range(3) for k in ("b", "w")]
    for name, lo, ex in zip(names, low, exact):
        if not bool(torch.isfinite(lo).all()):
            fail(f"[precision] bf16 posterior gradient {name} is not finite")
        if torch.equal(lo, ex):
            fail(f"[precision] bf16 posterior gradient {name} equals the f32 one")
    rss = lambda pairs: math.sqrt(sum(float((a.double() - b.double()).square().sum()) for a, b in pairs))  # noqa: E731
    d_cpu, d_f32 = rss((lo.cpu(), c) for lo, c in zip(low, cpu)), rss(zip(low, exact))
    norm = math.sqrt(sum(float(ex.double().square().sum()) for ex in exact))
    share = d_cpu / d_f32
    if not share < BF16_MODEL_NEARER:
        fail(f"[precision] the card's bf16 posterior gradient is {share:.3e} of its distance from f32 away from the "
             f"CPU's bf16 arithmetic (gate {BF16_MODEL_NEARER}): not the bf16 products")
    print(f"[precision] model_7 fc2-1024 B={B} S={S} posterior gradient: 12 finite leaves, each apart from f32 "
          f"({d_f32 / norm:.3e} of its norm, root sums of squares); {share:.3e} of that distance from the CPU's bf16 "
          f"twins (gate {BF16_MODEL_NEARER}; the CPU took {cpu_s:.1f} s)")
    return counts


def _cli_pgd_in_turns(torch, cli, flags, bf16_flags=(), bf16_env=None):
    """PGD through the attack CLI in f32 and in bf16 (``bf16_flags`` added, or
    ``bf16_env`` = (name, value) set), in turns f32, bf16, bf16, f32:
    images/s of each, and the last run of each."""
    rates, runs = {"f32": [], "bf16": []}, {}
    for label in ("f32", "bf16", "bf16", "f32"):
        bf16 = label == "bf16"
        with env_var(*bf16_env) if bf16 and bf16_env else contextlib.nullcontext():
            r = cli.main(flags + ["--attack_method=pgd"] + (list(bf16_flags) if bf16 else []))
        torch.cuda.synchronize()
        rates[label].append(len(r["x_test"]) / r["attack_seconds"])
        runs[label] = r
    return rates, runs


def check_in_ball(torch, phase: str, r, eps: float = 0.3) -> None:
    xa = r["x_attack"]
    x = torch.as_tensor(r["x_test"], device=xa.device)
    if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
        fail(f"[{phase}] adversarial set has shape {tuple(xa.shape)} or non-finite values")
    if float((xa - x).abs().max()) > eps + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
        fail(f"[{phase}] adversarial set leaves the eps-ball or [0, 1]")


def emulated_nearer(torch, what: str, arch, params, x, low, exact) -> float:
    """The card's bf16 logits ``low`` (and f32 ``exact``) of ``arch`` on
    ``params`` and ``x``, against the same model in the port's CPU bf16
    arithmetic on the first :data:`BF16_EMULATED_IMAGES` images: the distance
    from the CPU's, as a share of the distance from f32 (root sums of squares),
    must stay below :data:`BF16_MODEL_NEARER`. Returns that share."""
    from robustbnns_tpu_torch.utils.device import bf16_scope
    from robustbnns_tpu_torch.utils.pytree import map_params

    n = BF16_EMULATED_IMAGES
    with torch.no_grad(), bf16_scope():
        cpu = arch.apply(map_params(lambda t: t.cpu(), params), x[:n].cpu())
    low, exact = low[..., :n, :].cpu(), exact[..., :n, :].cpu()
    share = float((low - cpu).norm()) / float((low - exact).norm())
    if not share < BF16_MODEL_NEARER:
        fail(f"[precision] {what}: the card's bf16 logits are {share:.3e} of their distance from f32 away from the "
             f"CPU's bf16 arithmetic (gate {BF16_MODEL_NEARER}): not the bf16 products")
    return share


def phase_precision_paths(torch, workdir: str, main_counts: dict) -> dict:
    """The opt-ins end to end: model_7's fused FGSM and PGD under
    ROBUSTBNNS_KERNEL_PRECISION=default (bf16 kernels only, counted), PGD
    images/s against f32 in turns and the f32 kernels back once it is unset;
    model_0 through ``--bf16=True`` (logits against f32 on the same draws,
    x_adv in its ball, PGD images/s in turns, no sampled-dense launch);
    model_3's potential under HMC ``precision="default"`` against "high" at
    batch 5,000 and evaluations/s in turns; a 2-draw NUTS run. Returns the
    bf16 kernels' launches over model_7's FGSM + PGD."""
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.config import DATA, saved_BNNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.inference import hmc, nuts
    from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
    from robustbnns_tpu_torch.models.bnn import BNN, bnn_potential
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts
    from robustbnns_tpu_torch.predict import sample_eps
    from robustbnns_tpu_torch.utils.device import bf16_products, bf16_scope
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    if not os.path.abspath(DATA).startswith(workdir):
        fail(f"ROBUSTBNNS_DATA was not redirected to the temporary directory ({DATA})")
    # model_7, fused, ROBUSTBNNS_KERNEL_PRECISION=default ([main] saved its posterior)
    flags = ["--model_type=bnn", "--model_idx=7", "--fused=True", "--train=False", "--test=False",
             "--n_inputs=256", "--device=cuda"]
    with env_var("ROBUSTBNNS_KERNEL_PRECISION", "default"):
        reset_launch_counts()
        runs = {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}
        torch.cuda.synchronize()
        counts = launch_counts()
    print(f"[precision] model_7 fused FGSM + PGD under ROBUSTBNNS_KERNEL_PRECISION=default: launches "
          f"{json.dumps(counts)}")
    check_attack_launches("precision", counts, BF16_ATTACK_KERNELS)
    if any(counts[b] != main_counts[f] for f, b in zip(ATTACK_KERNELS, BF16_ATTACK_KERNELS)):
        fail(f"[precision] the bf16 kernels launched {counts}, not as often as [main]'s f32 ones {main_counts}")
    for r in runs.values():
        check_in_ball(torch, "precision", r)
    reset_launch_counts()
    rates, _ = _cli_pgd_in_turns(torch, cli, flags, bf16_env=("ROBUSTBNNS_KERNEL_PRECISION", "default"))
    turns = launch_counts()  # two PGD runs of each precision: the same launches of each
    if any(turns[f] != turns[b] or not turns[f] for f, b in zip(ATTACK_KERNELS, BF16_ATTACK_KERNELS)):
        fail(f"[precision] PGD in turns, with the variable set and unset, launched {turns}")
    reset_launch_counts()
    cli.main(flags + ["--attack_method=fgsm", "--bf16=True"])
    torch.cuda.synchronize()
    check_attack_launches("precision", launch_counts())  # the fused path ignores ROBUSTBNNS_BF16
    print(f"[precision] model_7 fused PGD on 256 images, in turns: f32 {[round(v, 1) for v in rates['f32']]} "
          f"images/s, bf16 kernels {[round(v, 1) for v in rates['bf16']]} images/s; unset again, the f32 kernels "
          f"launched {json.dumps({n: turns[n] for n in ATTACK_KERNELS})} as the bf16 ones did with it set; "
          f"--bf16=True --fused=True keeps the fused path on the f32 kernels")

    # model_0 through --bf16=True, unfused
    bnn = BNN.from_config(saved_BNNs["model_0"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = seeded_posterior(torch, bnn.arch)
    bnn.save(rel_path=DATA)
    flags0 = ["--model_type=bnn", "--model_idx=0", "--train=False", "--test=False", "--n_inputs=256",
              "--device=cuda"]
    with no_sampled_dense_launch(torch, "precision"):
        fgsm = cli.main(flags0 + ["--attack_method=fgsm", "--bf16=True"])
        rates0, runs0 = _cli_pgd_in_turns(torch, cli, flags0, bf16_flags=["--bf16=True"])
    if bf16_products():
        fail("[precision] --bf16=True left the bf16 switch thrown after the run")
    for r in (fgsm, runs0["bf16"]):
        check_in_ball(torch, "precision", r)
    post, x = fgsm["bnn"].posterior, torch.as_tensor(fgsm["x_test"][:B], device="cuda")
    w = sample_meanfield_eps(post, sample_eps(post.loc, S, seeds=list(range(S)), device="cuda"))
    with torch.no_grad():
        exact = bnn.arch.apply(w, x)
        with bf16_scope():
            low = bnn.arch.apply(w, x)
    logit_err = float((low - exact).abs().max() / exact.abs().max())
    if not 0 < logit_err <= BF16_LOGITS_OF_MAX:
        fail(f"[precision] model_0 bf16 logits {logit_err:.3e} of max from f32 (gate (0, {BF16_LOGITS_OF_MAX:.3e}])")
    emu0 = emulated_nearer(torch, "model_0 conv-512", bnn.arch, w, x, low, exact)
    print(f"[precision] model_0 conv-512 --bf16=True: FGSM and PGD x_adv in the eps-ball and [0, 1]; logits on "
          f"{S} seeded draws {logit_err:.3e} of max from f32 (gate (0, {BF16_LOGITS_OF_MAX:.3e}]), {emu0:.3e} of "
          f"that distance from the CPU's bf16 arithmetic on {BF16_EMULATED_IMAGES} images (gate "
          f"{BF16_MODEL_NEARER}); PGD on 256 images in turns: f32 {[round(v, 1) for v in rates0['f32']]} images/s, bf16 "
          f"{[round(v, 1) for v in rates0['bf16']]}")

    # model_3 under HMC precision="default", batch 5,000, cut to a few transitions
    bnn3 = BNN.from_config(saved_BNNs["model_3"], (28, 28, 1), 10, device="cuda")
    x3, y3, _, _, _, _ = load_dataset("fashion_mnist", n_inputs=PRECISION_HMC_IMAGES, fallback="synthetic")
    data = (torch.as_tensor(x3, device="cuda"), torch.as_tensor(y3, device="cuda").argmax(-1))
    q, unravel = flatten_tree_to_vector(bnn3.arch.init(torch.Generator(device="cuda").manual_seed(3)))
    pot = bnn_potential(bnn3.arch, unravel)
    with no_sampled_dense_launch(torch, "precision"):
        u_hi, g_hi = hmc._Potential(pot, data)(q)
        u_lo, g_lo = hmc._Potential(pot, data, bf16=True)(q)
        u_err = abs(float(u_lo - u_hi)) / abs(float(u_hi))
        g_err = float((g_lo - g_hi).abs().max() / g_hi.abs().max())
        if not (0 < u_err <= BF16_U_REL and 0 < g_err <= BF16_GRAD_OF_MAX):
            fail(f"[precision] model_3 U {u_err:.3e} (relative, gate (0, {BF16_U_REL:.0e}]) and grad {g_err:.3e} of "
                 f"max (gate (0, {BF16_GRAD_OF_MAX:.3e}]) from precision='high'")
        x3b, params3 = data[0][:B], unravel(q)
        with torch.no_grad():
            exact3 = bnn3.arch.apply(params3, x3b)
            with bf16_scope():
                low3 = bnn3.arch.apply(params3, x3b)
        emu3 = emulated_nearer(torch, "model_3 fc2-1024", bnn3.arch, params3, x3b, low3, exact3)
        cfg = hmc.HMCConfig(num_samples=3, warmup=0, step_size=1e-4, num_steps=10)
        rate = {"high": [], "default": []}
        for precision in ("high", "default", "default", "high"):
            out = []
            secs = wall_s(torch, lambda: out.append(hmc.hmc_sample(pot, q, 5, cfg._replace(precision=precision),
                                                                   data=data)))
            samples, info = out[0]
            if not bool(torch.isfinite(samples).all()):
                fail(f"[precision] model_3 HMC precision={precision!r}: non-finite draws")
            rate[precision].append(info.evaluations / secs)
        ncfg = nuts.NUTSConfig(num_samples=2, warmup=0, step_size=1e-4, max_depth=6, precision="default")
        out = []
        nuts_s = wall_s(torch, lambda: out.append(nuts.nuts_sample(pot, q, 6, ncfg, data=data)))
        draws, ninfo = out[0]
        if draws.shape != (2, q.numel()) or not bool(torch.isfinite(draws).all()):
            fail(f"[precision] NUTS precision='default': draws of shape {tuple(draws.shape)} or non-finite")
    flags_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(flags_tf32):
        fail(f"[precision] TF32 is on after the bf16 phase (matmul, cudnn) = {flags_tf32}")
    print(f"[precision] model_3 fashion_mnist fc2-1024 (D={q.numel()}) at batch {PRECISION_HMC_IMAGES}: "
          f"precision='default' U {u_err:.3e} relative from 'high' (gate (0, {BF16_U_REL:.0e}]), grad {g_err:.3e} of "
          f"max (gate (0, {BF16_GRAD_OF_MAX:.3e}]); logits under the sampler's bf16 scope {emu3:.3e} of their "
          f"distance from f32 away from the CPU's bf16 arithmetic (gate {BF16_MODEL_NEARER}); HMC, 3 transitions "
          f"of 10 steps, in turns: 'high' "
          f"{[round(v, 1) for v in rate['high']]} evaluations/s, 'default' {[round(v, 1) for v in rate['default']]}; "
          f"NUTS 'default', 2 draws with no warmup: {nuts_s:.3f} s, leaves {ninfo.num_leapfrog.tolist()}, finite; "
          f"TF32 off after (matmul, cudnn) = {flags_tf32}")
    return counts


def phase_precision(torch, workdir: str, main_counts: dict):
    """``[precision]``: :func:`phase_precision_kernels`,
    :func:`phase_precision_dparams`, :func:`phase_precision_param_grad`, then
    :func:`phase_precision_paths`; the bf16 kernels' results and their
    launches: the dparams kernels' over model_7's posterior gradient, the
    others' over model_7's FGSM + PGD."""
    t0 = time.perf_counter()
    results = phase_precision_kernels(torch)
    results.update(phase_precision_dparams(torch))
    grad_counts = phase_precision_param_grad(torch)
    counts = phase_precision_paths(torch, workdir, main_counts)
    counts = {**counts, **{name: grad_counts[name] for name in BF16_DPARAMS}}
    with env_var("ROBUSTBNNS_KERNEL_PRECISION", "default"):  # [attack-profile] on the bf16 kernels
        phase_attack_profile(torch, "precision", "PGD under ROBUSTBNNS_KERNEL_PRECISION=default")
    print(f"[precision] phase {time.perf_counter() - t0:.3f} s wall")
    return results, counts


def phase_training(torch) -> None:
    """Train model_7 through ``cli.train_bnn.run`` (training and the save; no
    figure), then attack the saved posterior through the attack CLI."""
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.cli import train_bnn
    from robustbnns_tpu_torch.inference.svi import svi_init
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    reset_launch_counts()
    trained = []
    train_s = wall_s(torch, lambda: trained.append(train_bnn.run(
        ["--model_idx=7", "--train=True", "--test=False", "--savedir=DATA", "--device=cuda"])))
    flags = ["--model_type=bnn", "--model_idx=7", "--train=False", "--fused=True",
             "--attack_method=pgd", "--n_inputs=256", "--device=cuda"]
    r = cli.main(flags)
    torch.cuda.synchronize()
    counts = launch_counts()
    bnn = trained[0]
    loss, acc, secs = bnn.history["loss"], bnn.history["accuracy"], bnn.history["seconds"]
    epochs, n_train = bnn.config.epochs, 60000
    later = secs[1:] or secs  # the first epoch also pays the process's first training launches
    print(f"[train] model_7 fc2-1024 through cli.train_bnn.run, {epochs} epochs of {n_train} images, batch "
          f"128: {train_s:.3f} s for the call (surrogate, training, save), {sum(secs):.3f} s in the epochs = "
          f"{epochs * n_train / sum(secs):.1f} training images/s; seconds per epoch {[round(v, 3) for v in secs]}, "
          f"epochs 2-{epochs} at {len(later) * n_train / sum(later):.1f} images/s; loss per image "
          f"{[round(v / n_train, 4) for v in loss]}; train accuracy {acc}")
    if not all(math.isfinite(v) for v in loss):
        fail(f"[train] non-finite epoch loss: {loss}")
    if not loss[-1] < loss[0]:
        fail(f"[train] the loss did not fall: {loss}")
    post = bnn.posterior
    leaves = tree_leaves(post.loc) + tree_leaves(post.rho)
    if any(v.requires_grad for v in leaves):
        fail("[train] the trained posterior keeps requires_grad leaves")
    loaded = r["bnn"].posterior
    if not all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(loaded.loc) + tree_leaves(loaded.rho))):
        fail("[train] the attack CLI loaded another posterior than cli.train_bnn.run saved")
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
    from robustbnns_tpu_torch.inference.svi import svi_train
    from robustbnns_tpu_torch.models.architectures import build_architecture

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "mnist")
    gen = torch.Generator(device="cuda").manual_seed(3)
    steps, n = 20, 20 * B
    x = torch.rand((n, 28, 28, 1), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (n,), generator=gen, device="cuda"), 10).float()
    run = lambda: svi_train(arch, x, y, epochs=1, lr=0.02, batch_size=B, verbose=False, device="cuda")  # noqa: E731
    wall = run()[1]["seconds"][0]
    step_ms, dev_ms = 1e3 * wall / steps, profiled_device_ms(torch, run, "train-profile")[0] / steps
    print(f"[train-profile] SVI step at fc2-1024, batch {B}, 10-draw train accuracy: "
          f"{step_ms:.3f} ms wall, {dev_ms:.3f} ms of device kernels "
          f"(device idle {100 * (1 - dev_ms / step_ms):.1f}% of the step)")


MESH_HMC_IMAGES, MESH_LOSS_GRAD_IMAGES = 5000, 256


def nccl_device_events(torch, fn) -> list:
    """The device events of a ``torch.profiler`` trace of ``fn`` that NCCL
    put there: its collectives' spans on NCCL's stream (``nccl:<op>``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s(torch, fn)
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()})


def same_bits(torch, phase: str, what: str, got, want) -> None:
    """Fail unless every tensor of ``got`` equals ``want``'s bit for bit."""
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"[{phase}] {what}: the mesh path at one rank differs from the unmeshed call")


def phase_mesh(torch, main_counts: dict, main_runs: dict) -> None:
    """The mesh path at one NCCL rank through the port's entry points, each
    stage held bit for bit to the same call without a mesh: the attack CLI
    with ``--mesh=auto`` against ``[main]`` (x_adv, launches, NCCL's
    collective in the device trace), one epoch of ``svi_train`` on model_7,
    HMC transitions and NUTS draws of model_3 at batch 5,000 through
    ``BNN.train``, a 10-member fc2 ensemble epoch, model_0's expected loss
    gradients at S = 10; and what the mesh costs at one rank, an SVI step and
    a PGD iteration, wall against device time. The default mesh and the group
    are taken down at the end."""
    import dataclasses

    import torch.distributed as dist

    from robustbnns_tpu_torch.analysis.gradients import expected_loss_gradients
    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.config import saved_BNNs, saved_NNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.inference.svi import svi_train
    from robustbnns_tpu_torch.models import build_architecture, train_ensemble
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts
    from robustbnns_tpu_torch.parallel import get_default_mesh, set_default_mesh, use_mesh
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    stages = {}

    def both(name, fn, leaves, warm=None):
        """``warm()`` (default ``fn()``) untimed, then ``fn()`` without the
        mesh, under it, under it and without it again, so neither order nor
        warm-up favours one; each pair's mean seconds into ``stages``. Fails
        unless all four give the same ``leaves(out)`` bit for bit. Returns a
        meshed result."""
        with use_mesh(None):
            (warm or fn)()
        out = {"meshed": [], "unmeshed": []}
        for what, m in (("unmeshed", None), ("meshed", mesh), ("meshed", mesh), ("unmeshed", None)):
            with use_mesh(m):
                seconds = wall_s(torch, lambda: out[what].append(fn()))
            stages[f"{name} {what}"] = stages.get(f"{name} {what}", 0.0) + seconds / 2
        want = leaves(out["unmeshed"][0])
        for what in ("meshed", "unmeshed"):
            for got in out[what]:
                same_bits(torch, "mesh", f"{name} ({what})", leaves(got), want)
        return out["meshed"][0]

    def cost(what, fn, units: int, unit: str) -> None:
        """What the mesh costs ``fn`` at one rank: its wall time meshed and
        unmeshed in turns (six each, medians) and its device-busy time under
        ``torch.profiler``, per ``unit``."""
        walls = {"meshed": [], "unmeshed": []}
        for _ in range(3):
            for label, m in (("unmeshed", None), ("meshed", mesh), ("meshed", mesh), ("unmeshed", None)):
                with use_mesh(m):
                    walls[label].append(1e3 * wall_s(torch, fn) / units)
        busy = {}
        for label, m in (("meshed", mesh), ("unmeshed", None)):
            with use_mesh(m):
                busy[label] = profiled_device_ms(torch, fn, "mesh")[0] / units
        wall = {label: statistics.median(v) for label, v in walls.items()}
        print(f"[mesh] {what}, a {unit}: {wall['meshed']:.3f} ms wall meshed, {wall['unmeshed']:.3f} ms unmeshed "
              f"(medians of 6 in turns; {wall['meshed'] / wall['unmeshed'] - 1:+.1%}); device kernels "
              f"{busy['meshed']:.4f} ms meshed, {busy['unmeshed']:.4f} ms unmeshed "
              f"({busy['meshed'] - busy['unmeshed']:+.4f} ms)")

    try:
        flags = ["--model_type=bnn", "--model_idx=7", "--fused=True", "--train=False", "--test=True",
                 f"--n_inputs={len(main_runs['pgd']['x_test'])}", "--device=cuda", "--mesh=auto"]
        reset_launch_counts()
        runs = {}
        stages["attack CLI"] = wall_s(torch, lambda: runs.update(
            {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}))
        counts = launch_counts()
        mesh = get_default_mesh()
        if mesh is None or mesh.shape != {"data": 1, "sample": 1} or dist.get_backend() != "nccl":
            fail(f"[mesh] --mesh=auto installed {mesh} over {dist.get_backend() if dist.is_initialized() else None}")
        if counts != main_counts:
            fail(f"[mesh] launches over FGSM + PGD {counts}, [main] {main_counts}")
        for m in ("fgsm", "pgd"):
            same_bits(torch, "mesh", f"{m} x_adv", [runs[m]["x_attack"]], [main_runs[m]["x_attack"]])
        print(f"[mesh] --mesh=auto: {mesh} over NCCL, {dist.get_world_size()} rank; FGSM and PGD x_adv bit-equal "
              f"to [main]'s; launches {json.dumps(counts)} equal [main]'s")

        bnn = runs["pgd"]["bnn"]
        x = torch.as_tensor(runs["pgd"]["x_test"][:B], device="cuda")
        y = torch.as_tensor(runs["pgd"]["y_test"][:B], device="cuda")
        pgd = lambda: attack(bnn, x, y, method="pgd", n_samples=S, fused=True, save=False, verbose=False)  # noqa: E731
        events = nccl_device_events(torch, pgd)
        if not any(name.startswith("nccl:") for name in events):
            fail(f"[mesh] the trace of one PGD batch holds no NCCL collective on the device: {events}")
        print(f"[mesh] the trace of one PGD batch of {B} under the mesh: NCCL on the device {events}")
        cost(f"PGD on model_7, {B} images, S={S}, fused", pgd, 40, "PGD iteration")

        cfg = saved_BNNs["model_7"]
        x_train, y_train, x_test, y_test, shape, classes = load_dataset("mnist", n_inputs=60000, fallback="synthetic")
        arch = build_architecture(cfg.architecture, cfg.activation, shape, classes, cfg.hidden_size, cfg.dataset)
        steps = 20
        xs, ys = x_train[: steps * B], y_train[: steps * B]
        svi_steps = lambda: svi_train(arch, xs, ys, epochs=1, lr=cfg.lr, batch_size=B,  # noqa: E731
                                      verbose=False, device="cuda")
        both("SVI epoch", lambda: svi_train(arch, x_train, y_train, epochs=1, lr=cfg.lr, batch_size=B,
                                            verbose=False, device="cuda"),
             lambda r: tree_leaves(r[0].loc) + tree_leaves(r[0].rho) + [torch.tensor(r[1]["loss"] + r[1]["accuracy"])],
             warm=svi_steps)
        print(f"[mesh] SVI epoch of 60000, posterior and history bit-equal: {stages['SVI epoch meshed']:.3f} s "
              f"meshed, {stages['SVI epoch unmeshed']:.3f} s unmeshed")
        cost(f"{steps} SVI steps of model_7 (fc2-1024, batch {B}, the 10-draw train accuracy) as one svi_train call",
             svi_steps, steps, "step")

        x3, y3, _, _, shape3, classes3 = load_dataset("fashion_mnist", n_inputs=MESH_HMC_IMAGES, fallback="synthetic")
        for sampler, changes in (("hmc", dict(n_samples=2, warmup=4)), ("nuts", dict(n_samples=1, warmup=0))):
            cfg3 = dataclasses.replace(saved_BNNs["model_3"], **changes)
            h = both(sampler, lambda: BNN.from_config(cfg3, shape3, classes3, device="cuda").train(
                x3, y3, batch_size=MESH_HMC_IMAGES, hmc_sampler=sampler, verbose=False),
                lambda b: tree_leaves(b.samples) + [torch.tensor([v for k in sorted(b.history) if k != "seconds"
                                                                  for v in b.history[k]])]).history
            print(f"[mesh] model_3 {sampler} at batch {MESH_HMC_IMAGES}, warmup {cfg3.warmup}, {cfg3.n_samples + 1} "
                  f"draws: draws and history bit-equal, {h['evaluations'][0]} evaluations, "
                  f"{stages[f'{sampler} meshed']:.3f} s meshed, {stages[f'{sampler} unmeshed']:.3f} s unmeshed")

        nn_cfg = saved_NNs["model_7"]
        ens_arch = build_architecture(nn_cfg.architecture, nn_cfg.activation, shape, classes, nn_cfg.hidden_size,
                                      nn_cfg.dataset)
        both("ensemble", lambda: train_ensemble(ens_arch, x_train, y_train, ensemble_size=10, epochs=1, lr=nn_cfg.lr,
                                                verbose=False, device="cuda"),
             lambda e: tree_leaves(e.stacked_params))
        print(f"[mesh] 10-member fc2-1024 ensemble epoch of 60000 bit-equal: {stages['ensemble meshed']:.3f} s "
              f"meshed, {stages['ensemble unmeshed']:.3f} s unmeshed")

        model0 = BNN.from_config(saved_BNNs["model_0"], (28, 28, 1), 10, device="cuda")
        model0.posterior = seeded_posterior(torch, model0.arch)
        xg, yg = x_test[:MESH_LOSS_GRAD_IMAGES], y_test[:MESH_LOSS_GRAD_IMAGES]
        both("loss gradients", lambda: expected_loss_gradients(model0, xg, yg, n_samples=S), lambda g: [g])
        print(f"[mesh] model_0 expected loss gradients at S={S} on {MESH_LOSS_GRAD_IMAGES} images bit-equal: "
              f"{stages['loss gradients meshed']:.3f} s meshed, {stages['loss gradients unmeshed']:.3f} s unmeshed")
        print(f"[mesh] stage seconds: {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    finally:
        set_default_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()


CONV_TOL_OF_MAX = 1e-4  # f32 against float64 through two convs, softmax and CE
LOOP_TOL_OF_MAX = 1e-5  # stacked against one draw at a time, both float64


def conv_reference(torch, arch, weights, x, choices=None):
    """model_0's network written out one draw at a time: (S, B, classes)
    logits and, per draw and conv layer, its discrete choices: which leaky
    units are on their positive branch, the slope, and the max-pool's argmax
    indices. Given ``choices``, each leaky unit takes the given branch and
    each max-pool its value at the given indices: float64 then follows the
    f32 run's choices, and a unit or a near-tie that rounds the other way in
    float64 does not reroute a gradient."""
    import torch.nn.functional as F

    from robustbnns_tpu_torch.models.architectures import ACTIVATIONS

    act, logits, chosen = ACTIVATIONS[arch.activation], [], []

    def layer_out(v, stride, given):
        if given is None:
            h, at = F.max_pool2d(act(v), 2, stride, return_indices=True)
            return h, (v > 0, 0.01, at)
        positive, slope, at = given
        h = torch.where(positive, v, slope * v)
        return h.flatten(2).gather(2, at.flatten(2)).reshape(at.shape), given

    for s in range(weights[0]["w"].shape[0]):
        (c1, c2, head), picks = ({k: v[s] for k, v in layer.items()} for layer in weights), []
        h = x.permute(0, 3, 1, 2)
        for layer, stride in ((c1, 2), (c2, 1)):
            v = F.conv2d(h, layer["w"].permute(3, 2, 0, 1), layer["b"])
            h, pick = layer_out(v, stride, None if choices is None else choices[s][len(picks)])
            picks.append(pick)
        logits.append(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1) @ head["w"] + head["b"])
        chosen.append(picks)
    return torch.stack(logits), chosen


def recorded_choices(torch, run, n_draws: int) -> list:
    """The discrete choices of the program's own f32 forward ``run()`` (a
    leaky conv model's), split by draw as :func:`conv_reference` takes them:
    ``torch.nn.functional.leaky_relu`` records which units are positive and
    its slope, ``max_pool2d`` its argmax indices, during the call. The
    reference then follows the convolutions the program ran, not its own f32
    pass, whose other order of sums can round a unit at its kink or a
    near-tie the other way."""
    import torch.nn.functional as F

    original_pool, original_leaky, pools, branches = F.max_pool2d, F.leaky_relu, [], []

    def pool(h, kernel_size, stride=None, *args, **kwargs):
        out, at = original_pool(h, kernel_size, stride, *args, return_indices=True, **kwargs)
        pools.append(at)
        return out

    def leaky(v, negative_slope=0.01, *args, **kwargs):
        branches.append((v > 0, negative_slope))
        return original_leaky(v, negative_slope, *args, **kwargs)

    F.max_pool2d, F.leaky_relu = pool, leaky
    try:
        with torch.no_grad():
            run()
    finally:
        F.max_pool2d, F.leaky_relu = original_pool, original_leaky

    def of_draw(t, s):
        return t.reshape(t.shape[0], n_draws, -1, *t.shape[2:])[:, s]

    return [[(of_draw(positive, s), slope, of_draw(at, s)) for (positive, slope), at in zip(branches, pools)]
            for s in range(n_draws)]


def phase_conv(torch) -> None:
    """model_0's seeded 10-draw predictive on the card: against float64 (a
    written-out reference that follows the f32 run's leaky branches and
    max-pool choices), the
    stacked apply against a loop over draws, and the time of one forward plus
    input gradient."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.predict import sample_eps
    from robustbnns_tpu_torch.utils.pytree import map_params, tree_leaves

    arch = BNN.from_config(saved_BNNs["model_0"], (28, 28, 1), 10, device="cuda").arch
    post = seeded_posterior(torch, arch, rel_scale=0.5)
    n_params = sum(v.numel() for v in tree_leaves(post.loc))
    w = sample_meanfield_eps(post, sample_eps(post.loc, S, seeds=range(S), device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.rand((B, 28, 28, 1), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda")

    def probs_and_grad(apply, weights, inp):
        inp = inp.clone().requires_grad_(True)
        probs = torch.softmax(apply(weights, inp), -1).mean(0)
        (grad,) = torch.autograd.grad(ce_on_outputs(probs, labels).sum(), inp)
        return probs.detach(), grad

    p32, g32 = probs_and_grad(arch.apply, w, x)
    choices = recorded_choices(torch, lambda: arch.apply(w, x), S)
    with torch.no_grad():
        own = conv_reference(torch, arch, w, x)[1]
    rerouted = [sum(int((run[k] != ref[k]).sum()) for draw, mine in zip(choices, own) for run, ref in zip(draw, mine))
                for k in (0, 2)]  # leaky branches, pool indices
    p64, g64 = probs_and_grad(lambda ws, inp: conv_reference(torch, arch, ws, inp, choices)[0],
                              map_params(torch.Tensor.double, w), x.double())
    if not (torch.isfinite(p32).all() and torch.isfinite(g32).all()):
        fail("[conv] the model_0 predictive gave non-finite values")
    errs = []
    for name, got, ref in (("probabilities", p32, p64), ("input gradient", g32, g64)):
        errs.append(float((got.double() - ref).abs().max() / ref.abs().max()))
        if errs[-1] > CONV_TOL_OF_MAX:
            fail(f"[conv] model_0 {name}: {errs[-1]:.3e} of max|float64| from float64 (tol {CONV_TOL_OF_MAX:.0e})")
    # The stacked apply against a loop of one-draw applies, both in float64, so
    # that a layout fault shows and f32 rounding does not: the head sums 25,088
    # products some 160 times larger than the logits, which leaves f32 logits
    # about 1e-5 of max from float64 in any order. The f32 stacked and looped
    # logits are held to float64 at the 1e-4 of the other float64 gates.
    w64, x64 = map_params(torch.Tensor.double, w), x.double()
    with torch.no_grad():
        looped64 = torch.stack([arch.apply(map_params(lambda v: v[s], w64), x64) for s in range(S)])
        scale = float(looped64.abs().max())
        loop_err = float((arch.apply(w64, x64) - looped64).abs().max()) / scale
        f32_errs = [float((logits.double() - looped64).abs().max()) / scale for logits in (
            arch.apply(w, x), torch.stack([arch.apply(map_params(lambda v: v[s], w), x) for s in range(S)]))]
    if loop_err > LOOP_TOL_OF_MAX:
        fail(f"[conv] stacked apply: {loop_err:.3e} of max|loop| from a loop over draws, both float64 "
             f"(tol {LOOP_TOL_OF_MAX:.0e})")
    if max(f32_errs) > CONV_TOL_OF_MAX:
        fail(f"[conv] f32 logits (stacked, looped) {f32_errs} of max from float64 (tol {CONV_TOL_OF_MAX:.0e})")
    run = lambda: probs_and_grad(arch.apply, w, x)  # noqa: E731
    run()
    walls = [wall_s(torch, run) for _ in range(5)]
    dev_ms, prof_ms = profiled_device_ms(torch, run, "conv")
    print(f"[conv] model_0 conv-512, {n_params} parameters ({2 * n_params} variational), B={B} S={S} "
          f"seeded: probabilities within {errs[0]:.3e} and input gradient within {errs[1]:.3e} of max|float64| "
          f"(tol {CONV_TOL_OF_MAX:.0e}; float64 on the run's leaky branches and pool choices, of which the "
          f"reference's own f32 pass takes {rerouted[0]} and {rerouted[1]} elsewhere); float64 stacked logits "
          f"within {loop_err:.3e} of a float64 loop over "
          f"draws (tol {LOOP_TOL_OF_MAX:.0e}); f32 logits from float64: stacked {f32_errs[0]:.3e}, looped "
          f"{f32_errs[1]:.3e} (tol {CONV_TOL_OF_MAX:.0e}); forward + input gradient "
          f"{1e3 * statistics.median(walls):.3f} ms wall (median of 5), {dev_ms:.3f} ms of device kernels "
          f"({prof_ms:.3f} ms wall under the profiler)")


GROUPED_CONV_SHAPES = (  # (B, S, hidden, input layout, the callers of that shape)
    (128, 100, 512, "channels_last", "model_0's attack at S = 100, the trunk's layout"),
    (128, 100, 512, "nchw", "model_0's attack at S = 100 on per-draw inputs"),
    (128, 10, 512, "channels_last", "model_0 at S = 10: the attack CLI, SVI's accuracy draws"),
    (100, 10, 512, "channels_last", "the 10-member ensemble's batch of 100"),
    (100, 10, 512, "nchw", "the 10-member ensemble on per-member inputs"),
    (128, 1, 256, "channels_last", "the NN path at hidden 256 (model_6)"),
    (128, 1, 512, "channels_last", "the NN path at hidden 512 (model_0)"),
    (64, 1, 512, "channels_last", "NN training's batch of 64"),
    (128, 1, 1024, "channels_last", "the NN path at hidden 1024 (model_2, 4, 8, 9)"),
)


GROUPED_CONV_DGRAD_SHAPES = (  # (B, S, hidden, layout of g and dx, the callers of that shape)
    (128, 100, 512, "channels_last", "model_0's attack at S = 100, the trunk's layout"),
    (128, 100, 512, "nchw", "model_0's attack at S = 100 on per-draw inputs"),
    (128, 10, 512, "channels_last", "model_0 at S = 10: the attack CLI"),
    (128, 1, 512, "channels_last", "SVI's ELBO step and the NN path: one image a block"),
)


def phase_grouped_conv(torch) -> dict:
    """``csrc/grouped_conv.cu`` at the shapes its callers give it
    (:data:`GROUPED_CONV_SHAPES`, model_0's attack first): against float64
    ``F.conv2d`` within (K + 1)·2⁻²⁴ of each output's absolute sum of terms
    (K = 800), bit-identical across calls, the output in the input's layout;
    its device time beside its bound (2·B·S·64·hidden·800 FLOP at the FP32
    peak), the plain version's (``F.conv2d`` with ``groups=S`` on the
    permuted weights) and the library's (``F.conv2d`` on weights permuted
    beforehand, what the trunk ran before the kernel). Then its input
    gradient at :data:`GROUPED_CONV_DGRAD_SHAPES` the same way: float64
    within (K + 1)·2⁻²⁴ (K = 25·hidden), bit-identical, dx in g's layout,
    the same bound, the plain twin's time (``F.conv_transpose2d``), the
    library's (``torch.nn.grad.conv2d_input``) and aten's input gradient with
    the input in g's layout (what the trunk ran before the kernel). Each
    result holds model_0's attack shape in the trunk's layout, and every
    shape under ``per_shape``."""
    import torch.nn.functional as F

    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    r = None
    for b_dim, n_draws, hidden, layout, callers in GROUPED_CONV_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(2026 + b_dim + n_draws + hidden)
        x = torch.rand((b_dim, 32 * n_draws, 12, 12), generator=gen, device="cuda")
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen, device="cuda") / 800**0.5
        bias = 0.1 * torch.randn((n_draws, hidden), generator=gen, device="cuda")
        w_oihw, b_flat = gc.oihw(w), bias.reshape(-1)
        flops = 2.0 * b_dim * n_draws * 64 * hidden * 800
        nbytes = 4.0 * (x.numel() + w.numel() + bias.numel() + b_dim * n_draws * hidden * 64)
        b_ms, b_by = bound_ms(flops, nbytes)
        shape = f"B={b_dim} S={n_draws} hidden={hidden} {layout}"
        got = gc.grouped_conv_fwd(x, w, bias)
        with torch.no_grad():
            exact = gc.grouped_conv_plain(x.double(), w.double(), bias.double())
            terms = gc.grouped_conv_plain(x.double().abs(), w.double().abs(), bias.double().abs())
            err = (got.double() - exact).abs()
            share = float((err / (801 * 2.0**-24 * terms)).max())
            rel = float(err.max() / exact.abs().max())
            del exact, terms, err
        if share > 1:
            fail(f"[grouped-conv] {shape}: {share:.3f} of the f32 bound (K + 1)·2⁻²⁴·Σ|terms| from float64")
        out_format = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        if not torch.equal(got, gc.grouped_conv_fwd(x, w, bias)) or not got.is_contiguous(memory_format=out_format):
            fail(f"[grouped-conv] {shape}: two calls differ, or the output left the input's layout")
        same = torch.equal(got, F.conv2d(x, w_oihw, b_flat, groups=n_draws))
        del got
        calls = 4 if n_draws * b_dim > 2000 else 20
        ms = device_ms(torch, lambda: gc.grouped_conv_fwd(x, w, bias), calls=calls)
        c_ms = call_ms(torch, lambda: gc.grouped_conv_fwd(x, w, bias), reps=10)
        plain_ms = device_ms(torch, lambda: gc.grouped_conv_plain(x, w, bias), calls=calls)
        lib_ms = device_ms(torch, lambda: F.conv2d(x, w_oihw, b_flat, groups=n_draws), calls=calls)
        print(f"[grouped-conv] {shape} ({callers}): max|err| {rel:.3e} of max|float64|, {share:.4f} of the f32 "
              f"bound; kernel {ms:.4f} ms (call {c_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% "
              f"of it, {flops / ms * 1e-9:.2f} TFLOP/s; plain {plain_ms:.4f} ms, library F.conv2d {lib_ms:.4f} ms "
              f"= {lib_ms / ms:.2f}x the kernel's time (bit-equal to the kernel: {same})")
        row = {"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": rel}
        if r is None:
            r = {"name": "grouped_conv_fwd", "route": "cuda", "source": "robustbnns_tpu_torch/csrc/grouped_conv.cu",
                 "replaces": "no Pallas kernel (XLA's conv in the JAX package); cuDNN's grouped conv in the port",
                 **row, "flops": flops, "bytes": nbytes, "per_shape": []}
        r["max_abs_err"] = max(r["max_abs_err"], rel)
        r["per_shape"].append(row)
    return {r["name"]: r, **phase_grouped_conv_dgrad(torch)}


def phase_grouped_conv_dgrad(torch) -> dict:
    """The input gradient of ``csrc/grouped_conv.cu`` (:func:`phase_grouped_conv`)."""
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    r = None
    for b_dim, n_draws, hidden, layout, callers in GROUPED_CONV_DGRAD_SHAPES:
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        gen = torch.Generator(device="cuda").manual_seed(2027 + b_dim + n_draws + hidden)
        g = torch.randn((b_dim, n_draws * hidden, 8, 8), generator=gen, device="cuda").contiguous(memory_format=fmt)
        w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen, device="cuda") / 800**0.5
        w_oihw, x_shape = gc.oihw(w), (b_dim, n_draws * 32, 12, 12)
        x = torch.zeros(x_shape, device="cuda").contiguous(memory_format=fmt)
        flops = 2.0 * b_dim * n_draws * 64 * hidden * 800
        nbytes = 4.0 * (g.numel() + w.numel() + math.prod(x_shape))
        b_ms, b_by = bound_ms(flops, nbytes)
        shape = f"dgrad B={b_dim} S={n_draws} hidden={hidden} {layout}"
        run = lambda: gc.grouped_conv_dgrad(g, w, 1, 0)  # noqa: E731
        aten = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            g, x, w_oihw, None, [1, 1], [0, 0], [1, 1], False, [0, 0], n_draws, [True, False, False])[0]
        got = run()
        with torch.no_grad():
            exact = gc.dgrad5x5_plain(g.double(), w.double())
            terms = gc.dgrad5x5_plain(g.double().abs(), w.double().abs())
            err = (got.double() - exact).abs()
            share = float((err / ((25 * hidden + 1) * 2.0**-24 * terms)).max())
            rel = float(err.max() / exact.abs().max())
            del exact, terms, err
        if share > 1:
            fail(f"[grouped-conv] {shape}: {share:.3f} of the f32 bound (K + 1)·2⁻²⁴·Σ|terms| from float64")
        if not torch.equal(got, run()) or got.stride() != aten().stride():
            fail(f"[grouped-conv] {shape}: two calls differ, or dx's strides are not aten's input gradient's")
        del got
        calls = 4 if n_draws * b_dim > 2000 else 20
        ms = device_ms(torch, run, calls=calls)
        c_ms = call_ms(torch, run, reps=10)
        plain_ms = device_ms(torch, lambda: gc.dgrad5x5_plain(g, w), calls=calls)
        lib_ms = device_ms(torch, lambda: torch.nn.grad.conv2d_input(x_shape, w_oihw, g, 1, 0, 1, n_draws),
                           calls=calls)
        aten_ms = device_ms(torch, aten, calls=calls)
        print(f"[grouped-conv] {shape} ({callers}): max|err| {rel:.3e} of max|float64|, {share:.4f} of the f32 "
              f"bound; kernel {ms:.4f} ms (call {c_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% "
              f"of it, {flops / ms * 1e-9:.2f} TFLOP/s; plain {plain_ms:.4f} ms, library conv2d_input "
              f"{lib_ms:.4f} ms = {lib_ms / ms:.2f}x, aten's input gradient in g's layout {aten_ms:.4f} ms = "
              f"{aten_ms / ms:.2f}x the kernel's time")
        row = {"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "aten_ms": aten_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": rel}
        if r is None:
            r = {"name": "grouped_conv_dgrad", "route": "cuda", "source": "robustbnns_tpu_torch/csrc/grouped_conv.cu",
                 "replaces": "no Pallas kernel (XLA's conv gradient in the JAX package); cuDNN's FFT dgrad in the port",
                 **row, "flops": flops, "bytes": nbytes, "per_shape": []}
        r["max_abs_err"] = max(r["max_abs_err"], rel)
        r["per_shape"].append(row)
        del g, x
    return {r["name"]: r}


CONV3X3_BATCH, CONV3X3_DRAWS = 128, 100  # resnet20.pgd.s100.eps8's batch and draws


def phase_grouped_conv3x3(torch) -> dict:
    """``csrc/grouped_conv3x3.cu`` at ResNet-20's five shapes (B 128, S 100,
    the PGD cell's), forward and input gradient: against its plain twins in
    float64 within (K + 1)·2⁻²⁴ of each output's absolute sum of terms (K =
    9·C summed products, and the forward's bias), bit-identical across calls;
    its device time beside its bound (2·B·S·side²·9·Ci·Co FLOP at the FP32
    peak, or each tensor's bytes once at HBM's rate), the plain twin's and the
    library's (``F.conv2d``, and ``torch.nn.grad.conv2d_input`` for the input
    gradient: cuDNN's grouped engine, what the trunk ran before the kernel).
    Returns one entry a mode for the ``kernels`` line, every shape under
    ``per_shape``."""
    import torch.nn.functional as F

    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    b_dim, n_draws = CONV3X3_BATCH, CONV3X3_DRAWS
    results = {}
    for mode in ("fwd", "dgrad"):
        r = None
        for (c_in, c_out, stride), side in gc.SHAPES3X3.items():
            out_side = side // stride
            gen = torch.Generator(device="cuda").manual_seed(2026 + c_in + c_out + stride)
            w = torch.randn((n_draws, 3, 3, c_in, c_out), generator=gen, device="cuda") / (9 * c_in) ** 0.5
            w_oihw = gc.oihw(w)
            x_shape = (b_dim, n_draws * c_in, side, side)
            if mode == "fwd":
                x = torch.rand(x_shape, generator=gen, device="cuda")
                bias = 0.1 * torch.randn((n_draws, c_out), generator=gen, device="cuda")
                b_flat = bias.reshape(-1)
                run = lambda: gc.grouped_conv_fwd(x, w, bias, stride, 1)  # noqa: E731
                twin = lambda f: gc.grouped_conv_plain(f(x), f(w), f(bias), stride, 1)  # noqa: E731
                lib = lambda: F.conv2d(x, w_oihw, b_flat, stride, 1, 1, n_draws)  # noqa: E731
                k_terms, nbytes = 9 * c_in + 1, 4.0 * (x.numel() + w.numel() + bias.numel()
                                                       + b_dim * n_draws * c_out * out_side**2)
            else:
                g = torch.randn((b_dim, n_draws * c_out, out_side, out_side), generator=gen, device="cuda")
                run = lambda: gc.grouped_conv_dgrad(g, w, stride, 1)  # noqa: E731
                twin = lambda f: gc.dgrad3x3_plain(f(g), f(w), stride)  # noqa: E731
                lib = lambda: torch.nn.grad.conv2d_input(x_shape, w_oihw, g, stride, 1, 1, n_draws)  # noqa: E731
                k_terms, nbytes = 9 * c_out, 4.0 * (g.numel() + w.numel() + math.prod(x_shape))
            flops = 2.0 * b_dim * n_draws * out_side**2 * 9 * c_in * c_out
            b_ms, b_by = bound_ms(flops, nbytes)
            shape = f"{mode} Ci={c_in} Co={c_out} stride={stride} side={side} B={b_dim} S={n_draws}"
            got = run()
            with torch.no_grad():
                exact = twin(lambda t: t.double())
                terms = twin(lambda t: t.double().abs())
                err = (got.double() - exact).abs()
                share = float((err / ((k_terms + 1) * 2.0**-24 * terms)).max())
                rel = float(err.max() / exact.abs().max())
                del exact, terms, err
            if share > 1:
                fail(f"[grouped-conv3x3] {shape}: {share:.3f} of the f32 bound (K + 1)·2⁻²⁴·Σ|terms| from float64")
            if not torch.equal(got, run()):
                fail(f"[grouped-conv3x3] {shape}: two calls differ")
            del got
            ms = device_ms(torch, run, calls=4)
            c_ms = call_ms(torch, run, reps=10)
            plain_ms = device_ms(torch, lambda: twin(lambda t: t), calls=4)
            lib_ms = device_ms(torch, lib, calls=4)
            print(f"[grouped-conv3x3] {shape}: max|err| {rel:.3e} of max|float64|, {share:.4f} of the f32 bound; "
                  f"kernel {ms:.4f} ms (call {c_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of "
                  f"it, {flops / ms * 1e-9:.2f} TFLOP/s; plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms = "
                  f"{lib_ms / ms:.2f}x the kernel's time")
            row = {"shape": shape, "ms": ms, "call_ms": c_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": rel}
            if r is None:
                r = {"name": f"grouped_conv3x3_{mode}", "route": "cuda",
                     "source": "robustbnns_tpu_torch/csrc/grouped_conv3x3.cu",
                     "replaces": "no Pallas kernel (the JAX package has no ResNet); cuDNN's grouped conv in the port",
                     **row, "flops": flops, "bytes": nbytes, "per_shape": []}
            r["max_abs_err"] = max(r["max_abs_err"], rel)
            r["per_shape"].append(row)
        print(f"[grouped-conv3x3] {mode}: the five shapes {sum(x['ms'] for x in r['per_shape']):.4f} ms, bound "
              f"{sum(x['bound_ms'] for x in r['per_shape']):.4f} ms, library "
              f"{sum(x['library_ms'] for x in r['per_shape']):.4f} ms")
        results[r["name"]] = r
    return results


def phase_resnet20_attack(torch) -> dict:
    """40-iteration PGD at ε 8/255 on a seeded ``resnet20`` posterior (width
    16, CIFAR-10's 32×32×3) at S 100 on one batch of 128 images, as the
    ``resnet20.pgd.s100.eps8`` cell attacks: inside the ε-ball and [0, 1],
    pixels moved, and every iteration's forward ran the 18 grouped 3×3 convs
    on the kernel and the first conv alone on ``F.conv2d``, and its input
    gradient the kernel's 18 input gradients, with no other hand-written
    kernel launched. Returns the launches by counter."""
    from robustbnns_tpu_torch import ops
    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.config import BNNConfig
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.utils import timing

    bnn = BNN.from_config(BNNConfig("cifar", 16, "relu", "resnet20", "svi"), (32, 32, 3), 10, device="cuda")
    bnn.posterior = seeded_posterior(torch, bnn.arch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((CONV3X3_BATCH, 32, 32, 3), generator=gen, device="cuda")
    y = torch.randint(0, 10, (CONV3X3_BATCH,), generator=gen, device="cuda")
    eps, iters = 8 / 255, 40
    run = lambda: attack(bnn, x, y, method="pgd", epsilon=eps, n_samples=CONV3X3_DRAWS, save=False,  # noqa: E731
                         verbose=False, generator=torch.Generator().manual_seed(12))
    run()  # the shapes warmed
    ops.reset_launch_counts()
    before = timing.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    convs = timing.counters()["resnet.cudnn_convs"] - before.get("resnet.cudnn_convs", 0)
    want = {"grouped_conv3x3.fwd": 18 * iters, "grouped_conv3x3.dgrad": 18 * iters}
    if counts != want or convs != iters:
        fail(f"[resnet20-attack] launches {counts} and {convs} F.conv2d convs for {iters} iterations: "
             f"want {want} and {iters}")
    if not bool(torch.isfinite(x_adv).all()) or float((x_adv - x).abs().max()) > eps + 1e-6 or float(
            x_adv.min()) < 0 or float(x_adv.max()) > 1:
        fail("[resnet20-attack] the adversarial batch is not finite or leaves the eps-ball or [0, 1]")
    moved = float(((x_adv - x).abs() > 1e-6).float().mean())
    if moved < 0.2:
        fail(f"[resnet20-attack] only {moved:.1%} of pixels moved")
    print(f"[resnet20-attack] PGD S={CONV3X3_DRAWS} B={CONV3X3_BATCH} eps 8/255: {wall:.3f} s = "
          f"{CONV3X3_BATCH / wall:.3f} images/s, {1e3 * wall / iters:.1f} ms an iteration; {moved:.1%} pixels "
          f"moved; launches {json.dumps(counts)}, {convs} F.conv2d convs (one an iteration)")
    return counts


@contextlib.contextmanager
def grouped_conv_launches(torch, phase: str, launches: dict):
    """Fail ``phase`` unless every forward of the conv trunk's second conv
    inside the block ran the grouped-conv kernel, one launch a forward (these
    phases run model_0 in f32 on the card, where the trunk routes every one to
    it), its input gradient launched at most once a forward, and no
    sampled-dense kernel launched. Records the launches by counter in
    ``launches[phase]``."""
    from robustbnns_tpu_torch import ops
    from robustbnns_tpu_torch.models import architectures

    forwards, routed = [], architectures._grouped_conv2d

    def counted(*args):
        forwards.append(1)
        return routed(*args)

    ops.reset_launch_counts()
    architectures._grouped_conv2d = counted
    try:
        yield
    finally:
        architectures._grouped_conv2d = routed
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    fwd, dgrad = counts.pop("grouped_conv.fwd"), counts.pop("grouped_conv.dgrad")
    if any(counts.values()):
        fail(f"[{phase}] launched a sampled-dense kernel: {counts}")
    if not fwd == len(forwards) > 0 or dgrad > fwd:
        fail(f"[{phase}] {fwd} grouped-conv launches for the conv trunk's {len(forwards)} forwards of its second conv, "
             f"{dgrad} of its input gradient")
    launches[phase] = {"grouped_conv.fwd": fwd, "grouped_conv.dgrad": dgrad}
    print(f"[{phase}] grouped-conv launches {fwd}, one for each of the trunk's {len(forwards)} second-conv forwards, "
          f"and {dgrad} of its input gradient; no sampled-dense launch")


def phase_model0_attack(torch, workdir: str) -> None:
    """FGSM and PGD on a seeded random model_0 posterior through the attack
    CLI, unfused, with no sampled-dense launch; then PGD's wall against device time."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.config import DATA, saved_BNNs
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts

    if not os.path.abspath(DATA).startswith(workdir):
        fail(f"ROBUSTBNNS_DATA was not redirected to the temporary directory ({DATA})")
    bnn = BNN.from_config(saved_BNNs["model_0"], (28, 28, 1), 10, device="cuda")
    bnn.posterior = seeded_posterior(torch, bnn.arch)
    bnn.save(rel_path=DATA)

    n_inputs, eps = 256, 0.3
    flags = ["--model_type=bnn", "--model_idx=0", "--train=False", "--test=True",
             f"--n_inputs={n_inputs}", "--device=cuda"]
    reset_launch_counts()
    runs = {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}
    torch.cuda.synchronize()
    counts = launch_counts()
    if any(counts.values()):
        fail(f"[model0-attack] the conv attack launched a sampled-dense kernel: {counts}")
    for method, r in runs.items():
        xa = r["x_attack"]
        x = torch.as_tensor(r["x_test"], device=xa.device)
        if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
            fail(f"[model0-attack] {method}: adversarial set has shape {tuple(xa.shape)} or non-finite values")
        if float((xa - x).abs().max()) > eps + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
            fail(f"[model0-attack] {method}: adversarial set leaves the eps-ball or [0, 1]")
        moved = float(((xa - x).abs() > 1e-6).float().mean())
        if moved < 0.2:
            fail(f"[model0-attack] {method}: only {moved:.1%} of pixels moved")
        print(f"[model0-attack] {method}: test acc {r['test_accuracy']:.2f}% | clean acc "
              f"{r['clean_accuracy']:.2f}% adversarial acc {r['adversarial_accuracy']:.2f}% | "
              f"{moved:.1%} pixels moved | attack {r['attack_seconds']:.3f} s = "
              f"{n_inputs / r['attack_seconds']:.1f} images/s; sampled-dense launches {json.dumps(counts)}")
    x = torch.as_tensor(runs["pgd"]["x_test"], device="cuda")
    y = torch.as_tensor(runs["pgd"]["y_test"], device="cuda")
    run = lambda: attack(bnn, x, y, method="pgd", n_samples=S, save=False, verbose=False)  # noqa: E731
    print_pgd_profile(torch, "model0-attack", "PGD on model_0 (unfused)", run, len(x), -(-len(x) // B) * 40)


NORTHSTAR_ATTACK_IMAGES, NORTHSTAR_ATTACK_SAMPLES, NORTHSTAR_DEFENCE_SAMPLES = 1000, 100, 500


def phase_northstar(torch):
    """``scripts/northstar.py`` through the port: train model_0, evaluate,
    PGD at S = 100, the 500-draw defence evaluation. Returns the trained BNN."""
    from robustbnns_tpu_torch.attacks import attack, attack_evaluation
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.inference.svi import svi_init
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    t_start = time.perf_counter()
    x_train, y_train, x_test, y_test, inp_shape, out = load_dataset(
        "mnist", n_inputs=60000, shuffle=True, fallback="synthetic")
    bnn = BNN.from_config(saved_BNNs["model_0"], inp_shape, out, device="cuda")
    stages = {}

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        result = []
        seconds = wall_s(torch, lambda: result.append(fn()))
        stages[name] = (seconds, torch.cuda.max_memory_allocated() / 2**30)
        return result[0]

    stage("train", lambda: bnn.train(x_train, y_train, batch_size=128, train_acc_samples=10, verbose=False))
    loss, acc = bnn.history["loss"], bnn.history["accuracy"]
    n_train, epochs = len(x_train), bnn.config.epochs
    if not all(math.isfinite(v) for v in loss):
        fail(f"[northstar] non-finite epoch loss: {loss}")
    if not loss[-1] < loss[0]:
        fail(f"[northstar] the loss did not fall: {loss}")
    leaves = tree_leaves(bnn.posterior.loc) + tree_leaves(bnn.posterior.rho)
    if any(v.requires_grad for v in leaves):
        fail("[northstar] the trained posterior keeps requires_grad leaves")
    init = svi_init(bnn.arch, torch.Generator(device="cuda").manual_seed(0))
    if all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(init.loc) + tree_leaves(init.rho))):
        fail("[northstar] the posterior equals its init")
    test_acc = stage("evaluate", lambda: bnn.evaluate(x_test, y_test, n_samples=10, verbose=False))

    n = NORTHSTAR_ATTACK_IMAGES
    xt = torch.as_tensor(x_test[:n], device="cuda")
    yt = torch.as_tensor(y_test[:n], device="cuda")
    x_adv = stage("pgd", lambda: attack(bnn, xt, yt, method="pgd", epsilon=0.3,
                                        n_samples=NORTHSTAR_ATTACK_SAMPLES, save=False, verbose=False))
    if x_adv.shape != xt.shape or not bool(torch.isfinite(x_adv).all()):
        fail(f"[northstar] x_adv has shape {tuple(x_adv.shape)} or non-finite values")
    if float((x_adv - xt).abs().max()) > 0.3 + 1e-6 or float(x_adv.min()) < 0 or float(x_adv.max()) > 1:
        fail("[northstar] x_adv leaves the eps-ball or [0, 1]")
    moved = float(((x_adv - xt).abs() > 1e-6).float().mean())
    clean, adv, rob = stage("defence", lambda: attack_evaluation(
        bnn, xt, x_adv, yt, n_samples=NORTHSTAR_DEFENCE_SAMPLES, verbose=False))
    images = {"train": epochs * n_train, "evaluate": len(x_test), "pgd": n, "defence": 2 * n}
    later = bnn.history["seconds"][1:]
    print(f"[northstar] model_0 conv-512, {epochs} epochs of {n_train} surrogate images, batch 128: loss per image "
          f"{[round(v / n_train, 4) for v in loss]}; train accuracy {[round(a, 2) for a in acc]}; seconds per "
          f"epoch {[round(v, 3) for v in bnn.history['seconds']]} (epochs 2-{epochs} at "
          f"{len(later) * n_train / sum(later):.1f} images/s)")
    print(f"[northstar] 10-draw test accuracy {test_acc:.2f}%; PGD S={NORTHSTAR_ATTACK_SAMPLES} on {n} images: "
          f"{moved:.1%} pixels moved; {NORTHSTAR_DEFENCE_SAMPLES}-draw defence: clean {clean:.2f}% adversarial "
          f"{adv:.2f}% softmax robustness {float(rob.mean()):.4f}")
    for name, (seconds, gib) in stages.items():
        print(f"[northstar] {name}: {seconds:.3f} s, {images[name] / seconds:.1f} images/s, "
              f"peak {gib:.2f} GiB allocated")
    print(f"[northstar] total {time.perf_counter() - t_start:.3f} s with the surrogate's generation")
    return bnn


def phase_loss_gradients(torch, bnn) -> None:
    """``cli.loss_gradients`` on the trained model_0 for S = 1, 10, 50, 100."""
    import numpy as np

    from robustbnns_tpu_torch.analysis import compute_vanishing_norms_idxs
    from robustbnns_tpu_torch.cli import loss_gradients as cli
    from robustbnns_tpu_torch.config import DATA

    bnn.save(rel_path=DATA)
    n = NORTHSTAR_ATTACK_IMAGES
    result = []
    seconds = wall_s(torch, lambda: result.append(
        cli.main(["--model_idx=0", f"--n_inputs={n}", "--savedir=DATA", "--device=cuda"])))
    grads = result[0]
    for samples, g in grads.items():
        if g.shape != (n, 28, 28) or not np.isfinite(g).all():
            fail(f"[loss-gradients] S={samples}: shape {g.shape} or non-finite values")
    stacked = np.stack([grads[k] for k in cli.POSTERIOR_SAMPLES_LIST], axis=1)
    vanishing = len(compute_vanishing_norms_idxs(stacked, cli.POSTERIOR_SAMPLES_LIST, verbose=False)) / n
    null = float((np.abs(stacked[:, 0]).reshape(n, -1).max(-1) == 0).mean())
    print(f"[loss-gradients] model_0 trained, {n} images, S={cli.POSTERIOR_SAMPLES_LIST}: {seconds:.3f} s; "
          f"max |grad| {[float(np.abs(grads[k]).max()) for k in cli.POSTERIOR_SAMPLES_LIST]}; vanishing "
          f"{vanishing:.3f}, increasing {1 - vanishing - null:.3f}, null {null:.3f} of the images")


HMC_PARITY_TOL_OF_MAX = 1e-4  # card against CPU, both f32: a 14-transition chain with mass adaptation
LEAPFROG_TOL_OF_MAX = 1e-5  # card f32 against CPU float64: one 10-step trajectory
HMC_MODEL_D = 1_863_690  # model_3's flat parameter vector: 784·1024 + 1024 + 1024·1024 + 1024 + 1024·10 + 10
HMC_TRAIN_IMAGES, HMC_ATTACK_IMAGES = 60000, 1000


@contextlib.contextmanager
def no_sampled_dense_launch(torch, phase: str):
    """Fail ``phase`` if a sampled-dense kernel launched inside the block: the
    HMC path reaches none."""
    from robustbnns_tpu_torch.ops.sampled_dense import launch_counts, reset_launch_counts

    reset_launch_counts()
    yield
    torch.cuda.synchronize()
    counts = launch_counts()
    if any(counts.values()):
        fail(f"[{phase}] launched a sampled-dense kernel: {counts}")
    print(f"[{phase}] sampled-dense launches: {json.dumps(counts)}")


@contextlib.contextmanager
def timed_stages(torch, stages: dict, *targets):
    """Time calls to ``getattr(owner, name)`` between two synchronisations with
    the card, summed into ``stages[label]``, for each ``(owner, name, label)``
    while the context is open."""
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]

    def timer(fn, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                stages[label] = stages.get(label, 0.0) + time.perf_counter() - t0
        return wrapper

    for (owner, name, fn), (_, _, label) in zip(originals, targets):
        setattr(owner, name, timer(fn, label))
    try:
        yield stages
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


class ReplayDraws:
    """Injected HMC draws (``inference.hmc.GeneratorDraws``'s methods), one
    queue per kind, moved to the asking tensor's device and dtype."""

    def __init__(self, search, momentum, uniform):
        self.queues = {"search": iter(search), "momentum": iter(momentum), "uniform": iter(uniform)}

    def search_normal(self, like):
        return next(self.queues["search"]).to(like)

    def momentum(self, like):
        return next(self.queues["momentum"]).to(like)

    def uniform(self, like):
        return next(self.queues["uniform"]).to(like)


def phase_hmc_parity(torch) -> None:
    """``hmc_sample`` on an fc-64 BNN potential at the Half Moons widths (2
    inputs, 2 classes, D = 322; 256 points) with the same injected draws on
    the card and on the CPU, both f32: a fixed step of 0.05, a warmup of 8
    with mass adaptation (a Welford window of 4 draws and the mass switch), 6
    draws of 5 leapfrog steps, accepts and rejects mixed. The widths keep the
    Hamiltonian small (about 400): at MNIST widths (D = 50,890) the kinetic
    energy alone is about 25,000, so an f32 log acceptance carries about 1e-3
    of rounding, the size of the decision margin, and two roundings take
    different decisions (a first card run parted at 0.38 of max). The step
    stays fixed for the same reason: dual averaging amplifies accept-rate
    noise (×20·sqrt(t)) until chains of any two roundings part; it is held on
    its own instead, 20 updates on the card against the CPU. Then one 10-step
    leapfrog trajectory of fc-64 at MNIST widths on the card against float64
    on the CPU."""
    from robustbnns_tpu_torch.inference import hmc
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    arch = build_architecture("fc", "leaky", (1, 2, 1), 2, 64, "half_moons")
    gen = torch.Generator().manual_seed(34)
    q0, unravel = flatten_tree_to_vector(arch.init(gen))
    d = q0.numel()
    x = torch.rand((256, 1, 2, 1), generator=gen)
    labels = torch.randint(0, 2, (256,), generator=gen)
    cfg = hmc.HMCConfig(num_samples=6, warmup=8, step_size=0.05, num_steps=5, adapt_step_size=False)
    n_trans = cfg.warmup + cfg.num_samples
    draws = ((), torch.randn((n_trans, d), generator=gen), torch.rand((n_trans,), generator=gen))
    potential = bnn_potential(arch, unravel)
    runs = {}
    for device in ("cuda", "cpu"):
        trace = []
        samples, info = hmc.hmc_sample(potential, q0.to(device), None, cfg, data=(x.to(device), labels.to(device)),
                                       draws=ReplayDraws(*draws), trace=trace)
        runs[device] = (samples.cpu(), info, trace)
    samples_gpu, info_gpu, _ = runs["cuda"]
    samples_cpu, info_cpu, trace = runs["cpu"]
    margins = [abs(float(u) - float(p)) for _, u, p in trace]
    if min(margins) <= 1e-3:  # the precondition of a whole-chain comparison
        fail(f"[hmc-parity] precondition: an accept decision within {min(margins):.2e} of its threshold")
    scale = float(samples_cpu.abs().max())
    err = float((samples_gpu - samples_cpu).abs().max()) / scale
    accept_err = float((info_gpu.accept_prob.cpu() - info_cpu.accept_prob).abs().max())
    mass_err = float(((info_gpu.inv_mass.cpu() - info_cpu.inv_mass).abs() / info_cpu.inv_mass).max())
    if not bool(torch.isfinite(samples_gpu).all()) or err > HMC_PARITY_TOL_OF_MAX or mass_err > HMC_PARITY_TOL_OF_MAX:
        fail(f"[hmc-parity] card chain {err:.3e} of max|cpu| and inverse mass {mass_err:.3e} (relative) from the "
             f"CPU's (tol {HMC_PARITY_TOL_OF_MAX:.0e}); accept probabilities card "
             f"{info_gpu.accept_prob.tolist()}, cpu {info_cpu.accept_prob.tolist()}")

    accept = torch.rand(20, generator=gen)
    states = []
    for device in ("cuda", "cpu"):
        state = hmc._fresh_dual_averaging(torch.full((), 0.0123, device=device))
        for it in range(20):
            state = hmc._dual_averaging_update(state, accept[it].to(device), 0.8, it)
        states.append(torch.stack(state).cpu())
    da_err = float(((states[0] - states[1]).abs() / states[1].abs()).max())
    if da_err > 1e-6:
        fail(f"[hmc-parity] dual averaging on the card {da_err:.3e} (relative) from the CPU's (tol 1e-6)")

    arch = build_architecture("fc", "leaky", (28, 28, 1), 10, 64, "mnist")
    gen = torch.Generator().manual_seed(32)
    q0, unravel = flatten_tree_to_vector(arch.init(gen))
    potential = bnn_potential(arch, unravel)
    x = torch.rand((256, 28, 28, 1), generator=gen)
    labels = torch.randint(0, 10, (256,), generator=gen)
    p = torch.randn(q0.numel(), generator=gen)
    inv_mass = torch.rand(q0.numel(), generator=gen) + 0.5
    ref = hmc._leapfrog(lambda q: potential(q, x.double(), labels), q0.double(), p.double(), 0.01,
                        inv_mass.double(), 10)
    got = hmc._leapfrog(lambda q: potential(q, x.cuda(), labels.cuda()), q0.cuda(), p.cuda(), 0.01,
                        inv_mass.cuda(), 10)
    lf_err = [float((g.cpu().double() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
    if max(lf_err) > LEAPFROG_TOL_OF_MAX:
        fail(f"[hmc-parity] leapfrog (q, p) {lf_err} of max from float64 (tol {LEAPFROG_TOL_OF_MAX:.0e})")
    print(f"[hmc-parity] fc-64 at the Half Moons widths (D={d}), 256 points, step {cfg.step_size}, warmup "
          f"{cfg.warmup} with mass adaptation, {cfg.num_samples} draws of {cfg.num_steps} steps (accept "
          f"{[round(a, 3) for a in info_cpu.accept_prob.tolist()]}), injected draws: card chain within "
          f"{err:.3e} of max|cpu| (tol {HMC_PARITY_TOL_OF_MAX:.0e}), accept probabilities within {accept_err:.3e}, "
          f"inverse mass within {mass_err:.3e} (relative); {len(trace)} accept decisions, the closest "
          f"{min(margins):.3e} from its threshold; 20 dual-averaging updates within {da_err:.3e} (relative, tol "
          f"1e-6); fc-64 at MNIST widths (D={q0.numel()}), 10-step leapfrog (q, p) within {lf_err[0]:.3e}, "
          f"{lf_err[1]:.3e} of max|float64| "
          f"(tol {LEAPFROG_TOL_OF_MAX:.0e})")


def phase_hmc(torch, workdir: str):
    """``cli.train_bnn --model_idx=3``: HMC training of Fashion-MNIST fc2-1024
    at full width on the 60,000-image surrogate (faithful: 12 batches of 5,000,
    each a warmup of 50 and 9 draws of 10 leapfrog steps; 100 draws resampled
    from the last), the 10-draw test evaluation, and the reload. Returns the
    trained BNN."""
    from robustbnns_tpu_torch.cli import train_bnn
    from robustbnns_tpu_torch.config import DATA
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    if not os.path.abspath(DATA).startswith(workdir):
        fail(f"ROBUSTBNNS_DATA was not redirected to the temporary directory ({DATA})")
    flags = ["--model_idx=3", f"--n_inputs={HMC_TRAIN_IMAGES}", "--savedir=DATA", "--device=cuda"]
    torch.cuda.reset_peak_memory_stats()
    result, stages = [], {}
    with timed_stages(torch, stages, (train_bnn, "load_data", "data"), (BNN, "train", "train"),
                      (BNN, "save", "save"), (BNN, "evaluate", "evaluate")):
        seconds = wall_s(torch, lambda: result.append(train_bnn.main(flags + ["--train=True", "--test=True"])))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bnn = result[0]
    cfg, h = bnn.config, bnn.history
    leaves = tree_leaves(bnn.samples)
    d = sum(v[0].numel() for v in leaves)
    if d != HMC_MODEL_D or any(v.shape[0] != cfg.n_samples for v in leaves):
        fail(f"[hmc] draws of shape ({[v.shape[0] for v in leaves]}, {d}), expected ({cfg.n_samples}, {HMC_MODEL_D})")
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        fail("[hmc] non-finite draws")
    init = tree_leaves(bnn.arch.init(torch.Generator(device="cuda").manual_seed(0)))
    moved = torch.stack([(v != i).reshape(cfg.n_samples, -1).any(-1) for v, i in zip(leaves, init)]).any(0)
    if not bool(moved.all()):
        fail(f"[hmc] {int((~moved).sum())} of {cfg.n_samples} draws equal the chain's init")
    steps = h["step_size"]
    if not all(math.isfinite(s) and 1e-10 <= s <= 1e3 for s in steps):
        fail(f"[hmc] step sizes not finite or outside [1e-10, 1e3]: {steps}")
    loaded = []
    reload_s = wall_s(torch, lambda: loaded.append(train_bnn.main(flags + ["--train=False", "--test=False"])))
    loaded = loaded[0]
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded.samples), leaves)):
        fail("[hmc] the reloaded checkpoint differs from the trained draws")
    _, _, x_test, y_test, _, _ = load_dataset("fashion_mnist", n_inputs=HMC_TRAIN_IMAGES, fallback="synthetic")
    accuracy = bnn.evaluate(x_test, y_test, n_samples=10, verbose=False)
    evals, train_s = sum(h["evaluations"]), sum(h["seconds"])
    print(f"[hmc] model_3 fashion_mnist fc2-1024 (D={d}), {len(steps)} batches of 5000, faithful, "
          f"{cfg.n_samples} draws, warmup {cfg.warmup}, {cfg.num_steps} leapfrog steps: {seconds:.3f} s for the "
          f"CLI call (surrogate, training, save, the 11 test evaluations), {train_s:.3f} s in the batch runs; "
          f"{evals} value-and-gradient evaluations = {evals / train_s:.1f} evaluations/s "
          f"({[e for e in h['evaluations']]} per batch); peak {peak_gib:.2f} GiB allocated; 10-draw test "
          f"accuracy {accuracy:.2f}%; reload bit-equal")
    print(f"[hmc] the CLI call's {seconds:.3f} s: loading the surrogate {stages['data']:.3f} s, BNN.train "
          f"{stages['train']:.3f} s (the batch runs {train_s:.3f}), the save of {cfg.n_samples} draws (compressed "
          f"npz) {stages['save']:.3f} s, the 11 test evaluations {stages['evaluate']:.3f} s, the rest "
          f"{seconds - sum(stages.values()):.3f} s; the reload through the CLI {reload_s:.3f} s")
    print(f"[hmc] per batch: mean accept {[round(a, 3) for a in h['accept']]}; step size "
          f"{[float(f'{s:.4g}') for s in steps]}; seconds {[round(s, 3) for s in h['seconds']]}")
    return bnn


def evaluation_flops(arch, batch: int) -> float:
    """One value-and-gradient evaluation of a dense BNN potential: the
    forward, the weight gradients and the input gradients of every layer
    but the first."""
    dims = arch.dims
    return 2.0 * batch * (2 * sum(i * o for i, o in dims) + sum(i * o for i, o in dims[1:]))


def profile_hmc_transition(torch, phase: str, bnn, x, labels) -> float:
    """One warmup transition of ``bnn``'s HMC config (``num_steps`` leapfrog
    steps, dual averaging and Welford) on the batch ``(x, labels)`` from its
    first draw at its last step size and mass: wall against device-busy
    time, with CUDA's sync debug mode set to error (a host read of a device
    value inside the transition fails the phase); then one value-and-gradient
    evaluation against its bound. Returns the device's idle share."""
    from robustbnns_tpu_torch.inference import hmc
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector, index_tree

    cfg, batch = bnn.config, x.shape[0]
    q, unravel = flatten_tree_to_vector(index_tree(bnn.samples, 0))
    vg = hmc._Potential(bnn_potential(bnn.arch, unravel), (x, labels))
    draws = hmc.GeneratorDraws(torch.Generator(device="cuda").manual_seed(5))
    eps = float(bnn.hmc_info.step_size)
    carry = (q, hmc._fresh_dual_averaging(torch.full((), eps, device="cuda")), hmc._welford_start(q),
             bnn.hmc_info.inv_mass)

    def transition():
        return hmc._hmc_warmup_chunk(vg, draws, carry, 0, 1, eps, cfg.num_steps, True, True, 0.8)

    transition()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        transition()
    except RuntimeError as e:
        fail(f"[{phase}] a transition synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    walls = [wall_s(torch, transition) for _ in range(3)]
    busy_ms, prof_ms = profiled_device_ms(torch, transition, phase)
    wall_ms = 1e3 * statistics.median(walls)
    eval_walls = [wall_s(torch, lambda: vg(q)) for _ in range(5)]
    eval_busy = profiled_device_ms(torch, lambda: [vg(q) for _ in range(10)], phase)[0] / 10
    flops = evaluation_flops(bnn.arch, batch)
    nbytes = 4.0 * (x.numel() + 3 * q.numel() + labels.numel())  # x, q read; gradient written; U
    b_ms, b_by = bound_ms(flops, nbytes)
    idle = 1 - busy_ms / wall_ms
    print(f"[{phase}] {bnn.config.dataset} {bnn.arch.name}-{bnn.arch.hidden_size} (D={q.numel()}) B={batch}, one "
          f"warmup transition of {cfg.num_steps} leapfrog steps ({cfg.num_steps + 1} evaluations): {wall_ms:.3f} ms "
          f"wall (median of {[round(1e3 * w, 3) for w in walls]}), {busy_ms:.3f} ms device-busy (union of kernel "
          f"intervals; {prof_ms:.3f} ms wall under the profiler), device idle {100 * idle:.1f}% of the wall; no host "
          f"synchronisation inside (sync debug mode 'error'); one evaluation {1e3 * statistics.median(eval_walls):.3f} "
          f"ms wall, {eval_busy:.3f} ms device-busy against a bound of {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP "
          f"at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s), {100 * b_ms / eval_busy:.1f}% of the bound; "
          f"{flops / eval_busy / 1e9:.1f} TFLOP/s")
    return idle


def phase_hmc_profile(torch, bnn) -> None:
    """:func:`profile_hmc_transition` on model_3 at B = 5,000 from a trained draw."""
    from robustbnns_tpu_torch.data.datasets import load_dataset

    x, y, _, _, _, _ = load_dataset("fashion_mnist", n_inputs=HMC_TRAIN_IMAGES, fallback="synthetic")
    profile_hmc_transition(torch, "hmc-profile", bnn, torch.as_tensor(x[:5000], device="cuda"),
                           torch.as_tensor(y[:5000], device="cuda").argmax(-1))


def phase_hmc_attack(torch) -> None:
    """FGSM and 40-step PGD at S = 10 on the trained model_3 through the
    attack CLI, on 1,000 test images: inside the ε-ball and [0, 1]. The
    share of pixels moved is printed, not gated (a trained posterior may
    saturate the softmax)."""
    from robustbnns_tpu_torch.cli import attacks as cli

    flags = ["--model_type=bnn", "--model_idx=3", "--train=False", "--test=False",
             f"--n_inputs={HMC_ATTACK_IMAGES}", "--device=cuda"]
    runs = {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}
    for method, r in runs.items():
        xa = r["x_attack"]
        x = torch.as_tensor(r["x_test"], device=xa.device)
        if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
            fail(f"[hmc-attack] {method}: adversarial set has shape {tuple(xa.shape)} or non-finite values")
        if float((xa - x).abs().max()) > 0.3 + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
            fail(f"[hmc-attack] {method}: adversarial set leaves the eps-ball or [0, 1]")
        moved = float(((xa - x).abs() > 1e-6).float().mean())
        print(f"[hmc-attack] {method}, S={S}, {len(x)} images: {len(x) / r['attack_seconds']:.1f} images/s "
              f"({r['attack_seconds']:.3f} s); clean acc {r['clean_accuracy']:.2f}% adversarial acc "
              f"{r['adversarial_accuracy']:.2f}%; {moved:.1%} of pixels moved")


def phase_hmc_loss_gradients(torch) -> None:
    """``cli.loss_gradients --model_idx=3`` on 1,000 test images, S = 1, 10, 50, 100."""
    import numpy as np

    from robustbnns_tpu_torch.analysis import compute_vanishing_norms_idxs
    from robustbnns_tpu_torch.cli import loss_gradients as cli

    n = HMC_ATTACK_IMAGES
    result = []
    seconds = wall_s(torch, lambda: result.append(
        cli.main(["--model_idx=3", f"--n_inputs={n}", "--savedir=DATA", "--device=cuda"])))
    grads = result[0]
    for samples, g in grads.items():
        if g.shape != (n, 28, 28) or not np.isfinite(g).all():
            fail(f"[hmc-loss-gradients] S={samples}: shape {g.shape} or non-finite values")
    stacked = np.stack([grads[k] for k in cli.POSTERIOR_SAMPLES_LIST], axis=1)
    vanishing = len(compute_vanishing_norms_idxs(stacked, cli.POSTERIOR_SAMPLES_LIST, verbose=False)) / n
    null = float((np.abs(stacked[:, 0]).reshape(n, -1).max(-1) == 0).mean())
    print(f"[hmc-loss-gradients] model_3 trained by HMC, {n} images, S={cli.POSTERIOR_SAMPLES_LIST}: "
          f"{seconds:.3f} s; max |grad| {[float(np.abs(grads[k]).max()) for k in cli.POSTERIOR_SAMPLES_LIST]}; "
          f"vanishing {vanishing:.3f}, increasing {1 - vanishing - null:.3f}, null {null:.3f} of the images")


NUTS_PARITY_TOL_OF_MAX = 1e-4  # card against CPU, both f32: one transition and a 10-draw chain
NUTS_RATE_D = 669_706  # fc2-512: 784·512 + 512 + 512·512 + 512 + 512·10 + 10
NUTS_RATE_BATCH, NUTS_RATE_DRAWS, NUTS_RATE_DEPTH = 60000, 8, 8
NUTS_TRAIN_IMAGES = 5000  # model_1's one faithful batch
NUTS_MIN_ACCEPT = 0.1  # an adapted chain accepts far more (0.477 at warmup 20); an unadapted one 0.010
NN_TRAIN_IMAGES, NN_ATTACK_IMAGES, ENSEMBLE_SIZE = 60000, 1000, 10


class ReplayNutsDraws:
    """Injected NUTS draws (``inference.hmc.GeneratorDraws``'s methods), one
    queue per kind, moved to the asking tensor's device and dtype."""

    def __init__(self, momentum, direction, merge, multinomial):
        self.queues = {k: iter(v) for k, v in (("momentum", momentum), ("direction", direction), ("merge", merge),
                                                ("multinomial", multinomial))}

    def _next(self, kind, like):
        return next(self.queues[kind]).to(like)

    def momentum(self, like):
        return self._next("momentum", like)

    def direction(self, like):
        return self._next("direction", like)

    def merge(self, like):
        return self._next("merge", like)

    def multinomial(self, like):
        return self._next("multinomial", like)


def nuts_margins(torch, trace) -> float:
    """The smallest distance of a NUTS decision from its threshold, in the
    unit of its scale (``inference.nuts._nuts_transition``'s trace), over
    the decisions that mattered (a threshold of ±inf decides for sure)."""
    closest = math.inf
    for _, value, threshold, scale, active in trace:
        value, threshold, scale, active = (torch.as_tensor(v).cpu() for v in (value, threshold, scale, active))
        gap = (value.double() - threshold.double()).abs() / scale.double()
        mattered = active & torch.isfinite(threshold)
        closest = min(closest, float(gap.masked_fill(~mattered.expand_as(gap), math.inf).min()))
    return closest


def phase_nuts_parity(torch) -> None:
    """One NUTS transition on an fc-64 BNN potential at the Half Moons widths
    (D = 322, 256 points) at a fixed step, with the same injected draws on the
    card and on the CPU, then a 10-draw fixed-step chain: the same leaf counts
    and divergences, positions within 1e-4·max, and every U-turn dot product,
    multinomial and merge comparison at least 1e-3 of its scale from its
    threshold (the precondition, checked first)."""
    from robustbnns_tpu_torch.inference import hmc, nuts
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    arch = build_architecture("fc", "leaky", (1, 2, 1), 2, 64, "half_moons")
    gen = torch.Generator().manual_seed(35)
    q0, unravel = flatten_tree_to_vector(arch.init(gen))
    d = q0.numel()
    x = torch.rand((256, 1, 2, 1), generator=gen)
    labels = torch.randint(0, 2, (256,), generator=gen)
    potential = bnn_potential(arch, unravel)
    inv_mass = torch.rand(d, generator=gen) + 0.5
    draws = (torch.randn((11, d), generator=gen), torch.rand((200,), generator=gen),
             torch.rand((200,), generator=gen), torch.rand((20000,), generator=gen))
    # A step of 0.05 keeps trees near 63 leaves. At 0.02 (trees of 127-255)
    # the card's chain parted from the CPU's by 0.85 of max with every
    # decision clear of its threshold: long trajectories amplify rounding.
    cfg = nuts.NUTSConfig(num_samples=10, warmup=0, step_size=0.05, max_depth=10, adapt_step_size=False,
                          adapt_mass_matrix=False)
    def run(device):
        data = (x.to(device), labels.to(device))
        replay = ReplayNutsDraws(*draws)
        vg = hmc._Potential(potential, data)
        trace = []
        one = nuts._nuts_transition(vg, q0.to(device), torch.tensor(0.05, device=device), inv_mass.to(device), 10,
                                    replay, trace)
        samples, info = nuts.nuts_sample(potential, q0.to(device), None, cfg, data=data, draws=replay, trace=trace)
        return one[0].cpu(), one[2], bool(one[3]), samples.cpu(), info, trace

    (q1_gpu, n1_gpu, d1_gpu, s_gpu, i_gpu, t_gpu), (q1_cpu, n1_cpu, d1_cpu, s_cpu, i_cpu, t_cpu) = map(
        run, ("cuda", "cpu"))
    margin = min(nuts_margins(torch, t_cpu), nuts_margins(torch, t_gpu))
    if margin <= 1e-3:  # the precondition of a trajectory comparison
        fail(f"[nuts-parity] precondition: a decision within {margin:.2e} of its scale from its threshold")
    leaves_gpu, leaves_cpu = [n1_gpu] + i_gpu.num_leapfrog.tolist(), [n1_cpu] + i_cpu.num_leapfrog.tolist()
    div_gpu, div_cpu = [d1_gpu] + i_gpu.diverging.tolist(), [d1_cpu] + i_cpu.diverging.tolist()
    if leaves_gpu != leaves_cpu or div_gpu != div_cpu:
        fail(f"[nuts-parity] leaves card {leaves_gpu} cpu {leaves_cpu}; divergences card {div_gpu} cpu {div_cpu}")
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in ((q1_gpu, q1_cpu), (s_gpu, s_cpu))]
    accept_err = float((i_gpu.accept_stat.cpu() - i_cpu.accept_stat).abs().max())
    if max(errs) > NUTS_PARITY_TOL_OF_MAX or not bool(torch.isfinite(s_gpu).all()):
        fail(f"[nuts-parity] the card's transition {errs[0]:.3e} and chain {errs[1]:.3e} of max|cpu| from the CPU's "
             f"(tol {NUTS_PARITY_TOL_OF_MAX:.0e})")
    print(f"[nuts-parity] fc-64 at the Half Moons widths (D={d}), 256 points: one transition at step 0.05 "
          f"({n1_cpu} leaves) within {errs[0]:.3e} of max|cpu|; a 10-draw chain at the same step (leaves "
          f"{leaves_cpu[1:]}, divergences {sum(div_cpu)}) within {errs[1]:.3e} (tol {NUTS_PARITY_TOL_OF_MAX:.0e}), "
          f"accept statistics within {accept_err:.3e}; {len(t_cpu)} recorded decisions, the closest {margin:.3e} of "
          f"its scale from its threshold")


def phase_nuts_rate(torch) -> None:
    """The JAX bench's saturated NUTS configuration (``bench.py:278-316``):
    fc2-512 at MNIST widths, 60,000 random inputs, 8 draws of max_depth 8 at a
    fixed step of 1e-5, no adaptation, so every draw runs 255 leaves; beside
    it the port's HMC evaluations per second on the same potential."""
    from robustbnns_tpu_torch.inference import hmc, nuts
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 512, "mnist")
    gen = torch.Generator(device="cuda").manual_seed(41)
    q0, unravel = flatten_tree_to_vector(arch.init(gen))
    data = (torch.rand((NUTS_RATE_BATCH, 28, 28, 1), generator=gen, device="cuda"),
            torch.randint(0, 10, (NUTS_RATE_BATCH,), generator=gen, device="cuda"))
    potential = bnn_potential(arch, unravel)
    if q0.numel() != NUTS_RATE_D:
        fail(f"[nuts-rate] D = {q0.numel()}, expected {NUTS_RATE_D}")
    cfg = nuts.NUTSConfig(num_samples=NUTS_RATE_DRAWS, warmup=0, step_size=1e-5, max_depth=NUTS_RATE_DEPTH,
                          adapt_step_size=False, adapt_mass_matrix=False)
    torch.cuda.reset_peak_memory_stats()
    result = []
    seconds = wall_s(torch, lambda: result.append(nuts.nuts_sample(potential, q0, 7, cfg, data=data)))
    samples, info = result[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    leaves = info.num_leapfrog.tolist()
    if leaves != [2**NUTS_RATE_DEPTH - 1] * NUTS_RATE_DRAWS or info.evaluations != sum(leaves) + NUTS_RATE_DRAWS:
        fail(f"[nuts-rate] leaves {leaves}, evaluations {info.evaluations}: expected 255 a draw and leaves + 8")
    if not bool(torch.isfinite(samples).all()):
        fail("[nuts-rate] non-finite draws")
    rate = info.evaluations / seconds
    hcfg = hmc.HMCConfig(num_samples=3, warmup=0, step_size=1e-5, num_steps=10, adapt_step_size=False,
                         adapt_mass_matrix=False)
    hmc.hmc_sample(potential, q0, 7, hcfg._replace(num_samples=1), data=data)  # warm
    result = []
    h_seconds = wall_s(torch, lambda: result.append(hmc.hmc_sample(potential, q0, 7, hcfg, data=data)))
    h_rate = result[0][1].evaluations / h_seconds
    vg = hmc._Potential(potential, data)
    eval_busy = profiled_device_ms(torch, lambda: [vg(q0) for _ in range(10)], "nuts-rate")[0] / 10
    flops = evaluation_flops(arch, NUTS_RATE_BATCH)
    b_ms, b_by = bound_ms(flops, 4.0 * (data[0].numel() + 3 * q0.numel() + data[1].numel()))
    print(f"[nuts-rate] fc2-512 (D={q0.numel()}), B={NUTS_RATE_BATCH}, {NUTS_RATE_DRAWS} draws of max_depth "
          f"{NUTS_RATE_DEPTH} at step 1e-5: leaves {leaves}, {info.evaluations} evaluations in {seconds:.3f} s = "
          f"{rate:.1f} evaluations/s; HMC on the same potential {h_rate:.1f} evaluations/s ({result[0][1].evaluations} "
          f"in {h_seconds:.3f} s), NUTS/HMC {rate / h_rate:.3f}; one evaluation {eval_busy:.3f} ms device-busy "
          f"against a bound of {b_ms:.3f} ms ({b_by}: {flops / 1e9:.1f} GFLOP at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{100 * b_ms / eval_busy:.1f}% of the bound; peak {peak_gib:.2f} GiB allocated")


def phase_nuts(torch):
    """model_1 (MNIST fc2-512, HMC config) trained by NUTS at full width
    through ``BNN.train(hmc_sampler="nuts")`` on one faithful batch of 5,000
    surrogate images, cut to 2 draws after a warmup of 20, where the step
    size has adapted (10 draws took about 28,000 leaves, 66 s); a floor on
    the mean accept probability; the 2-draw test evaluation, the save and a
    bit-equal reload. Returns the BNN and its batch."""
    import dataclasses

    from robustbnns_tpu_torch.config import DATA, saved_BNNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    cfg = dataclasses.replace(saved_BNNs["model_1"], n_samples=2, warmup=20)
    x, y, x_test, y_test, shape, out = load_dataset("mnist", n_inputs=60000, fallback="synthetic")
    x, y = x[:NUTS_TRAIN_IMAGES], y[:NUTS_TRAIN_IMAGES]
    bnn = BNN.from_config(cfg, shape, out, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    seconds = wall_s(torch, lambda: bnn.train(x, y, hmc_sampler="nuts", verbose=False))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    info, h = bnn.hmc_info, bnn.history
    leaves = tree_leaves(bnn.samples)
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        fail("[nuts] non-finite draws")
    init = tree_leaves(bnn.arch.init(torch.Generator(device="cuda").manual_seed(0)))
    moved = torch.stack([(v != i).reshape(cfg.n_samples, -1).any(-1) for v, i in zip(leaves, init)]).any(0)
    if not bool(moved.all()):
        fail(f"[nuts] {int((~moved).sum())} of {cfg.n_samples} draws equal the chain's init")
    step = float(info.step_size)
    if not (math.isfinite(step) and 1e-10 <= step <= 1e3):
        fail(f"[nuts] step size {step} not finite or outside [1e-10, 1e3]")
    if not h["accept"][0] >= NUTS_MIN_ACCEPT:
        fail(f"[nuts] mean accept probability {h['accept'][0]:.3f} below {NUTS_MIN_ACCEPT}")
    accuracy = bnn.evaluate(x_test, y_test, n_samples=cfg.n_samples, verbose=False)
    path = bnn.save(rel_path=DATA)
    loaded = BNN.from_config(cfg, shape, out, device="cuda").load(rel_path=DATA)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded.samples), leaves)):
        fail("[nuts] the reloaded checkpoint differs from the trained draws")
    nl = info.num_leapfrog.tolist()
    evals, run_s = h["evaluations"][0], h["seconds"][0]
    print(f"[nuts] model_1 mnist fc2-512 (D={sum(v[0].numel() for v in leaves)}), one faithful batch of "
          f"{len(x)} images, warmup {cfg.warmup} and {len(nl)} draws (resampled to {cfg.n_samples}): "
          f"{seconds:.3f} s ({run_s:.3f} s in the run), {evals} evaluations = {evals / run_s:.1f} evaluations/s; "
          f"leaves per draw {nl} (mean {sum(nl) / len(nl):.1f}, max {max(nl)}); divergences {int(h['divergences'][0])}; "
          f"mean accept {h['accept'][0]:.3f}; step {step:.4g}; {cfg.n_samples}-draw test accuracy {accuracy:.2f}%; peak "
          f"{peak_gib:.2f} GiB allocated; saved ({os.path.getsize(path) / 2**20:.1f} MiB) and reloaded bit-equal")
    return bnn, (torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda").argmax(-1))


def phase_nuts_profile(torch, bnn, data) -> None:
    """One NUTS draw on model_1 at B = 5,000 at a fixed step, from a trained
    draw with the trained step and mass: wall against device-busy time, the
    host reads per draw (the transition's own, and what CUDA's sync debug
    mode counts), and one evaluation against its bound."""
    import warnings

    from robustbnns_tpu_torch.inference import hmc, nuts
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector, index_tree

    q, unravel = flatten_tree_to_vector(index_tree(bnn.samples, 0))
    vg = hmc._Potential(bnn_potential(bnn.arch, unravel), data)
    eps, inv_mass = bnn.hmc_info.step_size, bnn.hmc_info.inv_mass
    max_depth = nuts.NUTSConfig(num_samples=1, warmup=0).max_depth

    def draw(seed):
        draws = hmc.GeneratorDraws(torch.Generator(device="cuda").manual_seed(seed))
        return nuts._nuts_transition(vg, q, eps, inv_mass, max_depth, draws)

    draw(1)
    reads = []
    flag = nuts._host_flag
    nuts._host_flag = lambda v: reads.append(1) or flag(v)
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            n_leaves = draw(2)[2]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        nuts._host_flag = flag
    sites = collections.Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    syncs = sum(sites.values())
    if len(reads) > n_leaves or syncs > n_leaves:
        fail(f"[nuts-profile] {len(reads)} host reads and {syncs} synchronisations in a draw of {n_leaves} leaves")
    walls = [wall_s(torch, lambda: draw(2)) for _ in range(3)]
    busy_ms, prof_ms = profiled_device_ms(torch, lambda: draw(2), "nuts-profile")
    wall_ms = 1e3 * statistics.median(walls)
    evals = n_leaves + 1
    eval_busy = profiled_device_ms(torch, lambda: [vg(q) for _ in range(10)], "nuts-profile")[0] / 10
    flops = evaluation_flops(bnn.arch, data[0].shape[0])
    b_ms, b_by = bound_ms(flops, 4.0 * (data[0].numel() + 3 * q.numel() + data[1].numel()))
    print(f"[nuts-profile] model_1 B={data[0].shape[0]}, one draw at the trained step {float(eps):.4g}: {n_leaves} "
          f"leaves ({evals} evaluations), {wall_ms:.3f} ms wall (median of {[round(1e3 * w, 3) for w in walls]}), "
          f"{busy_ms:.3f} ms device-busy ({prof_ms:.3f} ms wall under the profiler), device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the wall; {wall_ms / evals:.3f} ms wall and {busy_ms / evals:.3f} "
          f"ms device-busy an evaluation; host reads in the draw: {len(reads)} by the transition, {syncs} "
          f"synchronisations seen by CUDA's sync debug mode ({dict(sites)}); one evaluation {eval_busy:.3f} ms device-busy against a "
          f"bound of {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP), {100 * b_ms / eval_busy:.1f}% of the bound")


def check_adversarial(torch, phase: str, method: str, xa, x, eps: float = 0.3) -> float:
    """``x_adv`` finite, of ``x``'s shape, inside the ε-ball and [0, 1];
    returns the share of pixels moved."""
    x = torch.as_tensor(x, device=xa.device)
    if xa.shape != x.shape or not bool(torch.isfinite(xa).all()):
        fail(f"[{phase}] {method}: adversarial set has shape {tuple(xa.shape)} or non-finite values")
    if float((xa - x).abs().max()) > eps + 1e-6 or float(xa.min()) < 0 or float(xa.max()) > 1:
        fail(f"[{phase}] {method}: adversarial set leaves the eps-ball or [0, 1]")
    return float(((xa - x).abs() > 1e-6).float().mean())


def phase_nn(torch) -> None:
    """``cli.train_nn --model_idx=0`` (MNIST conv-512, 5 epochs, lr 0.01,
    batch 64) on 60,000 surrogate images; ``cli.attacks --model_type=nn``:
    FGSM and 40-step PGD on 1,000 images, then ``--attack=False`` reloading
    the saved PGD attack; then the deterministic expected loss gradient."""
    from robustbnns_tpu_torch.analysis import expected_loss_gradients
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.cli import train_nn

    out = []
    seconds = wall_s(torch, lambda: out.append(train_nn.main(
        ["--model_idx=0", f"--n_inputs={NN_TRAIN_IMAGES}", "--savedir=DATA", "--device=cuda"])))
    model, accuracy = out[0]["model"], out[0]["test_accuracy"]
    loss, acc, train_s = model.history["loss"], model.history["accuracy"], model.history["seconds"]
    if not all(math.isfinite(v) for v in loss) or not loss[-1] < loss[0]:
        fail(f"[nn] the loss is not finite and falling: {loss}")
    epochs = len(loss)
    print(f"[nn] model_0 conv-512 NN, {epochs} epochs of {NN_TRAIN_IMAGES} surrogate images, batch 64: loss per "
          f"image {[float(f'{v:.4g}') for v in loss]}; train accuracy {[round(a, 2) for a in acc]}; {train_s:.3f} s "
          f"training = {train_s / epochs:.3f} s an epoch ({epochs * NN_TRAIN_IMAGES / train_s:.1f} images/s); the "
          f"CLI call {seconds:.3f} s; test accuracy {accuracy:.2f}%")
    flags = ["--model_type=nn", "--model_idx=0", "--train=False", f"--n_inputs={NN_ATTACK_IMAGES}", "--device=cuda"]
    runs = {m: cli.main(flags + [f"--attack_method={m}", "--test=False"]) for m in ("fgsm", "pgd")}
    for method, r in runs.items():
        moved = check_adversarial(torch, "nn", method, r["x_attack"], r["x_test"])
        print(f"[nn] {method} on {NN_ATTACK_IMAGES} images: {NN_ATTACK_IMAGES / r['attack_seconds']:.1f} images/s "
              f"({r['attack_seconds']:.3f} s); clean acc {r['clean_accuracy']:.2f}% adversarial acc "
              f"{r['adversarial_accuracy']:.2f}%; {moved:.1%} of pixels moved")
    again = cli.main(flags + ["--attack_method=pgd", "--test=False", "--attack=False"])
    if not torch.equal(again["x_attack"], runs["pgd"]["x_attack"]):
        fail("[nn] the reloaded PGD attack differs from the one saved")
    r = runs["pgd"]
    result = []
    g_s = wall_s(torch, lambda: result.append(expected_loss_gradients(r["model"], r["x_test"], r["y_test"],
                                                                      n_samples=None)))
    grads = result[0]
    if grads.shape != r["x_test"].shape or not bool(torch.isfinite(grads).all()):
        fail(f"[nn] deterministic loss gradients of shape {tuple(grads.shape)} or non-finite")
    print(f"[nn] --attack=False reloaded the PGD attack bit-equal (adversarial acc "
          f"{again['adversarial_accuracy']:.2f}%); deterministic loss gradients on {len(grads)} images in "
          f"{g_s:.3f} s, max |grad| {float(grads.abs().max()):.4g}")


DETERMINISM_IMAGES = 5000  # a subset: one epoch of 50 steps


def check_ensemble_determinism(torch, ens) -> None:
    """Two one-epoch trainings of the 10 conv-512 members from one seed on
    5,000 surrogate images give bit-equal stacked leaves (cuDNN restricted to
    its deterministic algorithms by ``resolve_device``)."""
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models import train_ensemble
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    x, y, _, _, _, _ = load_dataset("mnist", n_inputs=60000, fallback="synthetic")
    x = torch.as_tensor(x[:DETERMINISM_IMAGES], device="cuda")
    y = torch.as_tensor(y[:DETERMINISM_IMAGES], device="cuda")
    out, seconds = [], []
    for _ in range(2):
        seconds.append(wall_s(torch, lambda: out.append(tree_leaves(train_ensemble(
            ens.arch, x, y, ensemble_size=ENSEMBLE_SIZE, device="cuda", epochs=1, lr=0.01, batch_size=100,
            verbose=False).stacked_params))))
    mismatched = [i for i, (a, b) in enumerate(zip(*out)) if not torch.equal(a, b)]
    if mismatched or not torch.backends.cudnn.deterministic:
        fail(f"[ensemble] two trainings from one seed differ in stacked leaves {mismatched}")
    print(f"[ensemble] determinism: two one-epoch trainings of {ENSEMBLE_SIZE} conv-512 members from seed 0..9 on "
          f"{DETERMINISM_IMAGES} images: all {len(out[0])} stacked leaves bit-equal ({[round(t, 3) for t in seconds]} s)")


def phase_ensemble(torch) -> None:
    """``cli.train_ensemble --model_idx=0 --ensemble_size=10`` (10 conv-512
    members, 5 epochs, batch 100) on 60,000 surrogate images;
    ``cli.attacks --model_type=ensemble``: FGSM and 40-step PGD on 1,000
    images; the ensemble's expected loss gradients at S = 10."""
    from robustbnns_tpu_torch.analysis import expected_loss_gradients
    from robustbnns_tpu_torch.cli import attacks as cli
    from robustbnns_tpu_torch.cli import train_ensemble
    from robustbnns_tpu_torch.utils.pytree import index_tree

    torch.cuda.reset_peak_memory_stats()
    out = []
    seconds = wall_s(torch, lambda: out.append(train_ensemble.main(
        ["--model_idx=0", f"--n_inputs={NN_TRAIN_IMAGES}", "--savedir=DATA", "--device=cuda",
         f"--ensemble_size={ENSEMBLE_SIZE}"])))
    train_gib = torch.cuda.max_memory_allocated() / 2**30
    ens, accuracy = out[0]["model"], out[0]["test_accuracy"]
    (loss,), train_s = ens.history["loss"], ens.history["seconds"]
    if not all(math.isfinite(v) for v in loss) or not loss[-1] < loss[0]:
        fail(f"[ensemble] the mean member loss is not finite and falling: {loss}")
    w = ens.stacked_params[0]["w"].reshape(ENSEMBLE_SIZE, -1)
    if any(torch.equal(w[i], w[j]) for i in range(ENSEMBLE_SIZE) for j in range(i)):
        fail("[ensemble] two members are equal")
    x = torch.rand((B, 28, 28, 1), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    loop = torch.stack([ens.arch.apply(index_tree(ens.stacked_params, e), x) for e in range(ENSEMBLE_SIZE)]).mean(0)
    avg = ens.logits(x)
    avg_err = float((avg - loop).abs().max() / loop.abs().max())
    if avg_err > 1e-5:
        fail(f"[ensemble] the stacked logit average is {avg_err:.3e} of max from a loop over members (tol 1e-5)")
    epochs = len(loss)
    print(f"[ensemble] model_0 conv-512, {ENSEMBLE_SIZE} members, {epochs} epochs of {NN_TRAIN_IMAGES} surrogate "
          f"images, batch 100: mean member loss per image {[float(f'{v:.4g}') for v in loss]}; {train_s:.3f} s training "
          f"= {train_s / epochs:.3f} s an epoch ({ENSEMBLE_SIZE * epochs * NN_TRAIN_IMAGES / train_s:.1f} member-"
          f"images/s); the CLI call {seconds:.3f} s; peak {train_gib:.2f} GiB allocated; test accuracy "
          f"{accuracy:.2f}%; logit average within {avg_err:.3e} of max of a loop over members")
    check_ensemble_determinism(torch, ens)
    flags = ["--model_type=ensemble", "--model_idx=0", f"--n_inputs={NN_ATTACK_IMAGES}", "--device=cuda"]
    torch.cuda.reset_peak_memory_stats()
    runs = {m: cli.main(flags + [f"--attack_method={m}"]) for m in ("fgsm", "pgd")}
    attack_gib = torch.cuda.max_memory_allocated() / 2**30
    for method, r in runs.items():
        moved = check_adversarial(torch, "ensemble", method, r["x_attack"], r["x_test"])
        print(f"[ensemble] {method} on {len(r['x_test'])} images through the {ENSEMBLE_SIZE}-member mean logits: "
              f"{len(r['x_test']) / r['attack_seconds']:.1f} images/s ({r['attack_seconds']:.3f} s); clean acc "
              f"{r['clean_accuracy']:.2f}% adversarial acc {r['adversarial_accuracy']:.2f}%; {moved:.1%} of pixels "
              f"moved; peak {attack_gib:.2f} GiB allocated")
    r = runs["pgd"]
    result = []
    g_s = wall_s(torch, lambda: result.append(expected_loss_gradients(r["model"], r["x_test"], r["y_test"],
                                                                      n_samples=ENSEMBLE_SIZE)))
    grads = result[0]
    if grads.shape != r["x_test"].shape or not bool(torch.isfinite(grads).all()):
        fail(f"[ensemble] loss gradients of shape {tuple(grads.shape)} or non-finite")
    print(f"[ensemble] expected loss gradients over the {ENSEMBLE_SIZE} members on {len(grads)} images in "
          f"{g_s:.3f} s, max |grad| {float(grads.abs().max()):.4g}")


def phase_env(torch) -> None:
    """Versions of the libraries the port uses, and which of the plotting and
    analysis packages the JAX package's figures need import here."""
    import numpy
    import scipy

    present = {}
    for name in ("matplotlib", "pandas", "seaborn", "sklearn"):
        try:
            importlib.import_module(name)
            present[name] = True
        except ImportError:
            present[name] = False
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {numpy.__version__}, scipy "
          f"{scipy.__version__}; imports: {json.dumps(present)}")
    a = torch.ones((16, 16), device="cuda", dtype=torch.bfloat16)
    try:  # ROBUSTBNNS_BF16's dense layers need cuBLAS's bf16 GEMM with an f32 output
        mm = torch.mm(a, a, out_dtype=torch.float32).dtype
        bmm = torch.bmm(a[None], a[None], out_dtype=torch.float32).dtype
        print(f"[env] torch.mm/bmm(bf16, bf16, out_dtype=torch.float32) on the card: {mm}, {bmm}")
    except (TypeError, RuntimeError) as e:
        fail(f"[env] torch {torch.__version__} has no f32-output bf16 GEMM on the card: {e}")


def run_phase(torch, phase: str, fn, *args):
    """``fn(torch, *args)`` as one phase: its wall seconds and peak device
    memory printed, and a failure if it launched a sampled-dense kernel."""
    torch.cuda.reset_peak_memory_stats()
    out = []
    with no_sampled_dense_launch(torch, phase):
        seconds = wall_s(torch, lambda: out.append(fn(torch, *args)))
    print(f"[{phase}] phase {seconds:.3f} s wall, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    return out[0]


@contextlib.contextmanager
def recorded_attacks(torch):
    """Record ``(epsilon, x, x_adv, model, seconds)`` of every
    ``attacks.attack`` call made through the package attribute (the
    experiments import it at call time), each call timed between two
    synchronisations with the card."""
    import robustbnns_tpu_torch.attacks as package

    original, record = package.attack, []

    def wrapper(model, x_test, y_test, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_adv = original(model, x_test, y_test, **kwargs)
        torch.cuda.synchronize()
        record.append((kwargs.get("epsilon", 0.3), x_test, x_adv, model, time.perf_counter() - t0))
        return x_adv

    package.attack = wrapper
    try:
        yield record
    finally:
        package.attack = original


GRID_CELL = ["--host_id=27", "--n_hosts=36"]  # cell 27 of the reference's 36: hidden 512, warmup 100, 5,000 points
GRID_NAME = ("half_moons_bnn_hmc_hid=512_act=leaky_arch=fc2_inp=5000_samp=250_warm=100_stepsize=0.001"
             "_numsteps=10")  # the JAX package's name for that cell (config.py:95-111)
GRID_TEST_POINTS, GRID_SAMPLES, GRID_D = 100, 250, 265_218  # fc2-512 on 2 inputs: 2·512 + 512 + 512² + 512 + 512·2 + 2


def phase_grid(torch) -> dict:
    """``cli.grid_search_half_moons`` on one cell of the reference sweep, its
    widest network: fc2-512, HMC faithful, 250 draws, warmup 100, 5,000
    points in 5 batches of 1,024 (the last 904), the expected gradients at
    S = 250 and FGSM on 100 test points; a rerun resumes from the checkpoint;
    one transition profiled at B = 1,024."""
    import numpy as np

    from robustbnns_tpu_torch.cli import grid_search_half_moons as cli
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    flags = GRID_CELL + ["--savedir=DATA", "--device=cuda", "--compute_grads=True", "--compute_attacks=True",
                         f"--test_points={GRID_TEST_POINTS}"]
    r = cli.run(flags)
    (bnn,) = r["trained"]
    if bnn.name != GRID_NAME:
        fail(f"[grid] the cell's name {bnn.name} is not the JAX package's {GRID_NAME}")
    leaves = tree_leaves(bnn.samples)
    d = sum(v[0].numel() for v in leaves)
    if d != GRID_D or any(v.shape[0] != GRID_SAMPLES for v in leaves) or \
            not all(bool(torch.isfinite(v).all()) for v in leaves):
        fail(f"[grid] draws of {[v.shape[0] for v in leaves]} x {d}, expected {GRID_SAMPLES} x {GRID_D} finite")
    (grads,) = r["grads"]
    if np.squeeze(np.zeros((GRID_TEST_POINTS, 1, 2, 1))).shape != grads.shape or not np.isfinite(grads).all():
        fail(f"[grid] gradients of shape {grads.shape} (the squeezed (100, 1, 2, 1) expected) or non-finite")
    (x_adv,) = r["attacks"]
    _, _, x_test, _, _, _ = load_dataset("half_moons", n_inputs=GRID_TEST_POINTS)
    moved = check_adversarial(torch, "grid", "fgsm", x_adv, x_test)

    def no_training(*args, **kwargs):
        fail("[grid] the rerun trained a cell that has a checkpoint")

    original, BNN.train = BNN.train, no_training
    try:
        rerun = cli.run(flags[:-3] + ["--compute_grads=False"])
    finally:
        BNN.train = original
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(rerun["trained"][0].samples), leaves)):
        fail("[grid] the resumed cell's draws differ from the trained ones")
    h = bnn.history
    evals, run_s = sum(h["evaluations"]), sum(h["seconds"])
    print(f"[grid] cell {GRID_CELL}: {bnn.name}: training {r['train_seconds']:.3f} s ({run_s:.3f} s in "
          f"{len(h['seconds'])} batch runs), {evals} evaluations = {evals / run_s:.1f} evaluations/s; mean accept "
          f"{[round(a, 3) for a in h['accept']]}; step {[float(f'{s:.4g}') for s in h['step_size']]}; expected "
          f"gradients at S={GRID_SAMPLES} on {GRID_TEST_POINTS} points {r['grads_seconds']:.3f} s (max |grad| "
          f"{float(np.abs(grads).max()):.4g}); FGSM {r['attack_seconds']:.3f} s, {moved:.1%} of coordinates moved; "
          f"the rerun resumed from the checkpoint without training")
    x, y, _, _, _, _ = load_dataset("half_moons", n_inputs=5000, shuffle=False)
    profile_hmc_transition(torch, "grid", bnn, torch.as_tensor(x[:1024], device="cuda"),
                           torch.as_tensor(y[:1024], device="cuda").argmax(-1))
    return r


def phase_overparam(torch, grid: dict) -> None:
    """The overparam rows of the grid cell written by
    ``build_overparam_scatterplot_dataset``, then ``cli.overparam.run
    --rebuild=False`` reading them back: 100 rows of the 15 columns, the
    gradient columns equal to the saved gradients."""
    from robustbnns_tpu_torch.analysis import load_loss_gradients
    from robustbnns_tpu_torch.cli import overparam as cli
    from robustbnns_tpu_torch.config import DATA
    from robustbnns_tpu_torch.experiments.overparam import build_overparam_scatterplot_dataset

    rows = []
    seconds = wall_s(torch, lambda: rows.extend(build_overparam_scatterplot_dataset(
        grid["cells"], grid["posterior_samples"], GRID_TEST_POINTS, rel_path=DATA, out_dir=DATA, verbose=False)))
    r = cli.run(["--rebuild=False", "--savedir=DATA", "--device=cuda", f"--test_points={GRID_TEST_POINTS}"])
    if r["built"] or len(r["rows"]) != GRID_TEST_POINTS or any(len(row) != 15 for row in r["rows"]):
        fail(f"[overparam] {len(r['rows'])} rows read (built again: {r['built']}), expected {GRID_TEST_POINTS} of 15 "
             "columns from the CSV")
    grads = load_loss_gradients(GRID_SAMPLES, GRID_NAME, GRID_NAME, DATA)
    for row, built, g in zip(r["rows"], rows, grads):
        if (row["loss_gradients_x"], row["loss_gradients_y"]) != (float(g[0]), float(g[1])) or row != built:
            fail(f"[overparam] a row differs from the saved gradients or from what was written: {row}")
    print(f"[overparam] {len(rows)} rows of 15 columns written in {seconds:.3f} s (test accuracy "
          f"{rows[0]['test_acc']:.2f}% at S={GRID_SAMPLES}), read back by the CLI equal, the gradient columns equal "
          f"to the saved gradients")


BASELINE_IMAGES, BASELINE_MEMBERS, BASELINE_CHECKED = 1000, 100, 64
CARD_CPU_RTOL = 1e-4  # the same checkpoint's softmax robustness on the card and on the CPU


def phase_baseline(torch) -> None:
    """``model_7``'s NN (``cli.train_nn``) and 100-member ensemble
    (``cli.train_ensemble``) trained on 60,000 surrogate images beside the
    SVI BNN that ``[train]`` saved, then ``cli.baseline_attacks.run`` at its
    defaults (1,000 images, FGSM, defence 1/50/100): 7,000 rows, every
    adversarial set in the ε-ball and [0, 1]; the NN's and the ensemble's rows
    of the first 64 images against the same checkpoints on the CPU."""
    from robustbnns_tpu_torch.attacks import attack as plain_attack
    from robustbnns_tpu_torch.attacks import attack_evaluation
    from robustbnns_tpu_torch.cli import baseline_attacks as cli
    from robustbnns_tpu_torch.cli import train_ensemble, train_nn
    from robustbnns_tpu_torch.config import DATA, EnsembleConfig, saved_NNs
    from robustbnns_tpu_torch.models import DeterministicNN, EnsembleNN

    flags = ["--model_idx=7", "--savedir=DATA", "--device=cuda"]
    nn_s = wall_s(torch, lambda: train_nn.main(flags))
    out = []
    ens_s = wall_s(torch, lambda: out.append(train_ensemble.main(flags + [f"--ensemble_size={BASELINE_MEMBERS}"])))
    ens_train = out[0]["model"].history["seconds"]
    with recorded_attacks(torch) as attacks:
        r = cli.run(flags)
    rows = r["rows"]
    if len(rows) != 7 * BASELINE_IMAGES:
        fail(f"[baseline] {len(rows)} rows, expected {7 * BASELINE_IMAGES}")
    if len(attacks) != 5:  # the NN, the BNN at one attack sample, the ensemble at 1, 50 and 100 members
        fail(f"[baseline] {len(attacks)} attacks, expected 5")
    ens_attack_s = [seconds for *_, model, seconds in attacks if isinstance(model, EnsembleNN)]
    if len(ens_attack_s) != 3:
        fail(f"[baseline] {len(ens_attack_s)} attacks on the ensemble, expected 3")
    for eps, x, xa, *_ in attacks:
        check_adversarial(torch, "baseline", "fgsm", xa, x, eps)
    blocks = {(row["model_type"], row["defence_samples"]): i for i, row in reversed(list(enumerate(rows)))}
    nn_cfg = saved_NNs["model_7"]
    cpu = torch.device("cpu")
    nn = DeterministicNN(arch=r["nn"].arch, params=None, name=nn_cfg.name, device=cpu).load(DATA)
    ens = EnsembleNN(arch=r["nn"].arch, stacked_params=None, ensemble_size=BASELINE_MEMBERS,
                     name=EnsembleConfig.from_nn(nn_cfg, BASELINE_MEMBERS).name, device=cpu).load(DATA)
    x, y = r["x_test"][:BASELINE_CHECKED], r["y_test"][:BASELINE_CHECKED]
    worst = 0.0
    for model, key, n in [(nn, ("nn", None), None)] + [(ens, ("ensemble", k), k) for k in (1, 50, 100)]:
        xa = plain_attack(model, x, y, method="fgsm", n_samples=n, save=False, verbose=False)
        rob = attack_evaluation(model, x, xa, y, n_samples=n, verbose=False)[2].tolist()
        card = [row["softmax_rob"] for row in rows[blocks[key]: blocks[key] + BASELINE_CHECKED]]
        ref = torch.tensor(rob, dtype=torch.float64)
        err = (torch.tensor(card, dtype=torch.float64) - ref).abs()
        if not bool((err <= CARD_CPU_RTOL * (ref.abs() + ref.abs().max())).all()):
            fail(f"[baseline] {key}: softmax robustness on the card parts from the CPU's by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    summary = {f"{k[0]}@{k[1]}": (rows[i]["test_acc"], rows[i]["adv_acc"]) for k, i in blocks.items()}
    print(f"[baseline] model_7 fc2-1024: NN trained in {nn_s:.3f} s (the CLI call), {BASELINE_MEMBERS}-member "
          f"ensemble {ens_train:.3f} s training = {ens_train / 5:.3f} s an epoch ({ens_s:.3f} s the CLI call); "
          f"cli.baseline_attacks {r['attack_seconds']:.3f} s for {len(rows)} rows ({len(attacks)} attacks of "
          f"{BASELINE_IMAGES} images, every one inside its eps-ball and [0, 1]); the {BASELINE_MEMBERS}-member "
          f"ensemble's FGSM at 1, 50 and 100 members {[round(t, 3) for t in ens_attack_s]} s = "
          f"{[round(BASELINE_IMAGES / t, 1) for t in ens_attack_s]} images/s; (clean, adversarial) accuracy by "
          f"(model, defence samples) {json.dumps(summary)}; the NN's and the ensemble's rows of the first "
          f"{BASELINE_CHECKED} images within {worst:.3e} of the CPU's (rtol {CARD_CPU_RTOL})")


def phase_eps(torch) -> None:
    """``cli.eps_attacks.run`` on ``model_7``'s posterior at its defaults: 100
    images, ε in {0.1, 0.15, 0.2, 0.25, 0.3} by S in {1, 10, 50}."""
    from robustbnns_tpu_torch.cli import eps_attacks as cli

    with recorded_attacks(torch) as attacks:
        r = cli.run(["--model_idx=7", "--savedir=DATA", "--device=cuda"])
    if len(r["rows"]) != 1500 or len(attacks) != 15:
        fail(f"[eps] {len(r['rows'])} rows from {len(attacks)} attacks, expected 1,500 from 15")
    for eps, x, xa, *_ in attacks:
        check_adversarial(torch, "eps", f"fgsm at eps {eps}", xa, x, eps)
    adv = {(row["epsilon"], row["n_samples"]): row["adv_acc"] for row in r["rows"]}
    print(f"[eps] model_7: 15 FGSM attacks of 100 images in {r['attack_seconds']:.3f} s, each inside its own eps-ball "
          f"and [0, 1]; test accuracy {r['test_accuracy']:.2f}%; adversarial accuracy by (eps, S) "
          f"{json.dumps({f'{e}/{s}': a for (e, s), a in adv.items()})}")


def phase_gradients_components(torch) -> None:
    """``cli.gradients_components.run --compute_grads=True`` on ``model_7``,
    1,000 images: S in {1, 10, 50, 100} computed and saved, then S in {1, 10,
    100} read back bit-equal."""
    import numpy as np

    from robustbnns_tpu_torch.analysis import compute_vanishing_norms_idxs
    from robustbnns_tpu_torch.cli import gradients_components as cli

    r = cli.run(["--model_idx=7", "--savedir=DATA", "--device=cuda", "--compute_grads=True"])
    for s, g in zip(cli.STRIP_SAMPLES, r["strip"]):
        if g.shape != (1000, 28, 28) or not np.isfinite(g).all():
            fail(f"[gradients-components] S={s}: shape {g.shape} or non-finite values")
    for s, g in zip(cli.HEATMAP_SAMPLES, r["heatmaps"]):
        if not np.array_equal(g, r["strip"][cli.STRIP_SAMPLES.index(s)]):
            fail(f"[gradients-components] S={s}: the reloaded gradients differ from the computed ones")
    vanishing = compute_vanishing_norms_idxs(np.stack(r["heatmaps"], axis=1), cli.HEATMAP_SAMPLES, verbose=False)
    print(f"[gradients-components] model_7, 1000 images: S={cli.STRIP_SAMPLES} computed and saved in "
          f"{r['strip_seconds']:.3f} s, S={cli.HEATMAP_SAMPLES} read back bit-equal in {r['heatmaps_seconds']:.3f} s; "
          f"{len(vanishing)} images flagged for heatmap rows")


MULTIMODAL_TOL_OF_MAX = 1e-3  # the card's PCA (float64 products) against numpy's float64 on the CPU


def phase_multimodal(torch) -> None:
    """``cli.multimodal.run`` uncut: ``model_10`` (MNIST fc2-512, D = 669,706),
    50 draws after a warmup of 100, one full-batch chain at each of 1,000,
    10,000 and 60,000 points; 1,000 prior draws; the card's PCA of the prior
    against numpy's float64 PCA on the CPU; one transition of the 60,000-point
    chain profiled."""
    import numpy as np

    from robustbnns_tpu_torch.cli import multimodal as cli
    from robustbnns_tpu_torch.experiments import multimodal
    from robustbnns_tpu_torch.models.bnn import BNN

    stages, chains, prior = {}, [], []

    def train(self, x, y, **kwargs):
        out = originals[0](self, x, y, **kwargs)
        chains.append((self, x, y))
        return out

    def keep(fn, into):
        def wrapper(*args, **kwargs):
            into.append(fn(*args, **kwargs))
            return into[-1]
        return wrapper

    originals = BNN.train, multimodal.prior_draws
    BNN.train, multimodal.prior_draws = train, keep(multimodal.prior_draws, prior)
    try:
        with timed_stages(torch, stages, (multimodal, "prior_draws", "prior"), (multimodal, "pca_fit", "pca"),
                          (multimodal, "pca_transform", "pca"), (BNN, "save", "save"),
                          (BNN, "evaluate", "evaluate")):
            r = cli.run(["--device=cuda"])
    finally:
        BNN.train, multimodal.prior_draws = originals
    rows = r["rows"]
    if len(rows) != 1000 + 3 * 50 or not all(math.isfinite(row["x"]) and math.isfinite(row["y"]) for row in rows):
        fail(f"[multimodal] {len(rows)} rows, expected 1,150 finite")
    t0 = time.perf_counter()
    xc = prior[0].astype(np.float64)
    xc -= xc.mean(0)
    u = np.linalg.eigh(xc @ xc.T)[1][:, -2:][:, ::-1]
    axes = (xc.T @ u).T
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    axes *= np.sign(axes[np.arange(2), np.abs(axes).argmax(1)])[:, None]
    ref = xc @ axes.T
    cpu_s = time.perf_counter() - t0
    card = np.array([[row["x"], row["y"]] for row in rows[:1000]])
    err = float(np.abs(card - ref).max() / np.abs(ref).max())
    clear = np.abs(ref) > MULTIMODAL_TOL_OF_MAX * np.abs(ref).max()
    if err > MULTIMODAL_TOL_OF_MAX or (np.sign(card) != np.sign(ref))[clear].any():
        fail(f"[multimodal] the prior's PCA is {err:.3e} of max from the CPU's float64 PCA or flips a sign")
    per_chain = [(x.shape[0], sum(b.history["evaluations"]), sum(b.history["seconds"]), b.history["accept"][0],
                  float(b.hmc_info.step_size)) for b, x, _ in chains]
    print(f"[multimodal] model_10 mnist fc2-512 (D={prior[0].shape[1]}), 50 draws after warmup 100, full batch: "
          f"the CLI call {r['build_seconds']:.3f} s; prior draws {stages['prior']:.3f} s; PCA {stages['pca']:.3f} s "
          f"(the prior's within {err:.3e} of max of numpy's float64 PCA on the CPU, {cpu_s:.3f} s there, no sign "
          f"flipped); checkpoint saves {stages['save']:.3f} s, test evaluations {stages['evaluate']:.3f} s")
    for n, evals, secs, accept, step in per_chain:
        print(f"[multimodal] chain at {n} points: {secs:.3f} s, {evals} evaluations = {evals / secs:.1f} "
              f"evaluations/s; mean accept {accept:.3f}; step {step:.4g}")
    bnn, x, y = chains[-1]
    profile_hmc_transition(torch, "multimodal", bnn, torch.as_tensor(x, device="cuda"),
                           torch.as_tensor(y, device="cuda").argmax(-1))


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    t_start = time.perf_counter()
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
        phase_env(torch)
        phase_device(torch)
        phase_build(workdir)
        kernels = phase_kernels(torch)
        phase_reference(torch)
        phase_fwd_edges(torch)
        phase_dx_edges(torch)
        phase_dparams_edges(torch)
        phase_predictive(torch)
        grad_counts = phase_param_grad(torch)
        counts, main_runs = phase_main_path(torch, workdir)
        phase_attack_profile(torch)
        bf16_kernels, bf16_counts = phase_precision(torch, workdir, counts)
        mesh_s = wall_s(torch, lambda: phase_mesh(torch, counts, main_runs))
        print(f"[mesh] phase {mesh_s:.3f} s wall")
        del main_runs
        phase_training(torch)
        phase_train_profile(torch)
        phase_conv(torch)
        grouped = phase_grouped_conv(torch)
        conv3x3 = phase_grouped_conv3x3(torch)
        conv3x3_launches = phase_resnet20_attack(torch)
        conv_launches = {}
        with grouped_conv_launches(torch, "model0-attack", conv_launches):
            phase_model0_attack(torch, workdir)
        with grouped_conv_launches(torch, "northstar", conv_launches):
            trained = phase_northstar(torch)
        with grouped_conv_launches(torch, "loss-gradients", conv_launches):
            phase_loss_gradients(torch, trained)
        del trained
        torch.cuda.empty_cache()
        with no_sampled_dense_launch(torch, "hmc-parity"):
            phase_hmc_parity(torch)
        with no_sampled_dense_launch(torch, "hmc"):
            hmc_bnn = phase_hmc(torch, workdir)
        with no_sampled_dense_launch(torch, "hmc-profile"):
            phase_hmc_profile(torch, hmc_bnn)
        del hmc_bnn
        torch.cuda.empty_cache()
        with no_sampled_dense_launch(torch, "hmc-attack"):
            phase_hmc_attack(torch)
        with no_sampled_dense_launch(torch, "hmc-loss-gradients"):
            phase_hmc_loss_gradients(torch)
        torch.cuda.empty_cache()
        with no_sampled_dense_launch(torch, "nuts-parity"):
            phase_nuts_parity(torch)
        with no_sampled_dense_launch(torch, "nuts-rate"):
            phase_nuts_rate(torch)
        torch.cuda.empty_cache()
        with no_sampled_dense_launch(torch, "nuts"):
            nuts_bnn, nuts_data = phase_nuts(torch)
        with no_sampled_dense_launch(torch, "nuts-profile"):
            phase_nuts_profile(torch, nuts_bnn, nuts_data)
        del nuts_bnn, nuts_data
        torch.cuda.empty_cache()
        with grouped_conv_launches(torch, "nn", conv_launches):
            phase_nn(torch)
        with grouped_conv_launches(torch, "ensemble", conv_launches):
            phase_ensemble(torch)
        torch.cuda.empty_cache()
        grid = run_phase(torch, "grid", phase_grid)
        run_phase(torch, "overparam", phase_overparam, grid)
        del grid
        run_phase(torch, "baseline", phase_baseline)
        torch.cuda.empty_cache()
        run_phase(torch, "eps", phase_eps)
        run_phase(torch, "gradients-components", phase_gradients_components)
        run_phase(torch, "multimodal", phase_multimodal)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    line = []
    for name, r in {**kernels, **bf16_kernels, **grouped, **conv3x3}.items():
        line.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": sum(p[name.replace("_fwd", ".fwd").replace("_dgrad", ".dgrad")] for p in conv_launches.values())
            if name in grouped else
            conv3x3_launches[name.replace("_fwd", ".fwd").replace("_dgrad", ".dgrad")] if name in conv3x3 else
            (grad_counts if name in DPARAMS else bf16_counts if name in bf16_kernels else counts)[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_ms(r["flops"], r["bytes"], r.get("peak_flops", PEAK_FP32_FLOPS))[1],
            "library_ms": r["library_ms"], **({"f32_ms": r["f32_ms"]} if "f32_ms" in r else {}),
            "per_shape": r["per_shape"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
