"""The bf16 parameter-gradient head (O <= 16) of ``csrc/sampled_dense_dparams_bf16.cu`` on the CPU.

dloc, drho, dbloc and dbrho of the 10-class head, the Pallas
``_bwd_xs_dparams_kernel`` and ``_bwd_dparams_kernel`` under
``Precision.DEFAULT`` (dW_s = bf16(x_s)ᵀ bf16(g_s), the bias from the unrounded
g). The source runs through the g++ emulation of
``tests/test_torch_kernel_emulation.py`` (``tests/cuda_emulation/``: one
std::thread per CUDA thread, the blocks of a cluster at once, the
non-portable cluster attribute accepted). Held here:

* both instances (per-sample xs and shared x) against their bf16 twins at
  the f32 gate, dloc and drho nearer them than a tenth of their distance from
  the f32 twins, at ragged shapes on ``dparams_bf16_plan``'s geometry
  (ten ranks of one sample, as at model_7's 1024 -> 10, among them) and at
  every split of the samples into 1 .. 17 runs (ranks of one cluster up to
  16, then ranks of two runs); the
  outputs NaN-filled first, so a missed store shows;
* dbloc and dbrho bit-equal to the f32 source's narrow kernel at every split
  (the same runs of samples, summed in the same order), and xs_dparams on x
  broadcast over the samples bit-equal to dparams;
* both against JAX's Pallas kernels (interpret mode, the VJP of
  ``sampled_dense_xs`` and ``sampled_dense`` in the parameters) under
  ROBUSTBNNS_KERNEL_PRECISION=default on bf16 values at zero scale (dloc and
  dbloc within 1e-5; drho and dbrho carry σ(-30) and vanish in both);
* the earlier design, moved to
  ``scripts/comparison_kernels/sampled_dense_dparams_bf16_narrow_partials.cu``
  for ``chip_smoke.py`` to time beside the head, still builds and meets the
  same twins on its partial planes.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_kernel_emulation as emulation

from robustbnns_tpu.ops import sampled_dense as jax_sampled_dense
from robustbnns_tpu.ops import sampled_dense_xs as jax_sampled_dense_xs

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

SEED = 2026
COMPARISON = Path(__file__).resolve().parents[1] / "scripts" / "comparison_kernels"


@pytest.fixture(scope="module")
def head_library(tmp_path_factory):
    return emulation.build(tmp_path_factory, "sampled_dense_dparams_bf16.cu", emulation.DPARAMS_BF16)


@pytest.fixture(scope="module")
def f32_library(tmp_path_factory):
    return emulation.build(tmp_path_factory, "sampled_dense_dparams.cu", emulation.DPARAMS)


def run_head(dll, g, x, rho, brho, n_split):
    """One call of the head at ``n_split`` runs (no scratch); outputs NaN-filled."""
    return emulation.run_dparams(dll, g, x, rho, brho, SEED, 132, bf16=True, n_split=n_split)[0]


def run_f32_narrow(dll, g, x, rho, brho, n_split):
    """dbloc and dbrho of the f32 source's narrow kernel at ``n_split`` runs,
    with partial planes of that many runs."""
    (s, b, o), i = g.shape, rho.shape[0]
    outs = [torch.full((i, o), float("nan")) for _ in range(2)] + [torch.full((o,), float("nan")) for _ in range(2)]
    partials = torch.full((n_split, 2, i + 1, o), float("nan")) if n_split > 1 else None
    err = dll.sampled_dense_dparams(g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr(),
                                    partials.data_ptr() if partials is not None else None,
                                    *(t.data_ptr() for t in outs), s, b, i, o, SEED, n_split, None)
    assert err == 0
    return outs[2], outs[3]


@pytest.mark.parametrize("shape,sms,runs,ranks", [
    ((37, 70, 10, 3), 132, 3, 3),  # I = 70 ragged over three input blocks, two 64-row chunks (the second of 5 rows)
    ((1, 70, 13, 1), 132, 1, 1),  # one row, O % 4 != 0: plain loads of g, one rank
    ((129, 2, 2, 2), 132, 2, 2),  # O = 2, I = 2: plain loads of x, three chunks (the last of one row)
    ((5, 200, 10, 40), 4, 2, 2),  # S = 40 in two runs of 20 samples
    ((65, 33, 12, 17), 132, 17, 16),  # 17 runs in 16 ranks of one non-portable cluster, one rank of two runs
    ((128, 96, 10, 10), 132, 10, 10),  # ten ranks of one sample in one cluster, as model_7's head
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_head_matches_bf16_twins_on_its_plan(head_library, f32_library, shape, sms, runs, ranks):
    """Both instances on the plan against their twins; the bias bit-equal to
    the f32 kernel's on its own plan; xs_dparams on a broadcast x equal to
    dparams."""
    b, i, o, s = shape
    g, x, xs, rho, brho = emulation.dparams_case(shape)
    got, plan = emulation.run_dparams(head_library, g, x, rho, brho, SEED, sms, bf16=True)
    assert (plan.narrow, plan.n_split, plan.ranks, plan.scratch) == (True, runs, ranks, ())
    got_xs, _ = emulation.run_dparams(head_library, g, xs, rho, brho, SEED, sms, bf16=True)
    emulation.check_dparams_bf16(got, g, x, rho, brho, s)
    emulation.check_dparams_bf16(got_xs, g, xs, rho, brho, s)
    f32, _ = emulation.run_dparams(f32_library, g, x, rho, brho, SEED, sms)
    assert torch.equal(got[2], f32[2]) and torch.equal(got[3], f32[3])
    broadcast, _ = emulation.run_dparams(head_library, g, x.expand(s, b, i).contiguous(), rho, brho, SEED, sms,
                                         bf16=True)
    assert all(torch.equal(a, c) for a, c in zip(broadcast, got))


@pytest.mark.parametrize("shape", [
    (20, 70, 10, 17),  # ragged I and B, O = 10: 1 .. 17 runs, 16 ranks from 16 runs on
    (70, 36, 13, 6),  # O % 4 != 0, two chunks a sample (the second of 6 rows)
], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_head_at_every_split(head_library, f32_library, shape):
    """Every run count 1 .. S (one cluster of up to 16 ranks, then ranks that
    hold two runs' bias subtotals), both instances: against the twins; the
    bias bit-equal to the f32 kernel's at the same split; the splits within
    the reordering of their f32 sums of one another."""
    b, i, o, s = shape
    g, x, xs, rho, brho = emulation.dparams_case(shape)
    first = None
    for n_split in range(1, s + 1):
        got, got_xs = run_head(head_library, g, x, rho, brho, n_split), run_head(head_library, g, xs, rho, brho, n_split)
        emulation.check_dparams_bf16(got, g, x, rho, brho, s)
        emulation.check_dparams_bf16(got_xs, g, xs, rho, brho, s)
        dbloc, dbrho = run_f32_narrow(f32_library, g, x, rho, brho, n_split)
        assert torch.equal(got[2], dbloc) and torch.equal(got[3], dbrho), n_split
        first = first or got
        for got_t, first_t in zip(got, first):
            torch.testing.assert_close(got_t, first_t, rtol=1e-5, atol=1e-5 * float(first_t.abs().max()))


def bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float()


@pytest.mark.parametrize("variant", ["x", "xs"])
@pytest.mark.parametrize("shape", [(37, 70, 10, 3), (70, 36, 13, 2)], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_head_matches_jax_at_zero_scale(head_library, shape, variant, monkeypatch):
    """bf16-valued x (or xs) and g, rho = brho = -30: the head against
    ``jax.vjp`` through JAX's interpret-mode ``sampled_dense`` /
    ``sampled_dense_xs`` under ROBUSTBNNS_KERNEL_PRECISION=default (its
    ``_bwd_dparams_kernel`` / ``_bwd_xs_dparams_kernel``): dloc and dbloc
    within 1e-5 (exact products, <= S·B-term f32 sums of O(1) values in
    another order); drho and dbrho vanish in both."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    b, i, o, s = shape
    rng = np.random.default_rng(17)
    xin = bf16_values(rng.normal(size=(b, i) if variant == "x" else (s, b, i)))
    g = bf16_values(rng.normal(size=(s, b, o)))
    loc, bloc = (rng.normal(size=(i, o)) * 0.1).astype(np.float32), (rng.normal(size=(o,)) * 0.1).astype(np.float32)
    neg, negb = np.full((i, o), -30.0, np.float32), np.full((o,), -30.0, np.float32)
    op = jax_sampled_dense if variant == "x" else jax_sampled_dense_xs
    _, vjp = jax.vjp(lambda *params: op(xin.numpy(), *params, s, SEED), loc, neg, bloc, negb)
    want = vjp(jnp.asarray(g.numpy()))
    n_split = sd.dparams_bf16_plan(s, b, i, o, 132).n_split
    got = run_head(head_library, g, xin, torch.from_numpy(neg), torch.from_numpy(negb), n_split)
    for name, got_t, want_t in zip(("dloc", "drho", "dbloc", "dbrho"), got, want):
        if name in ("dloc", "dbloc"):
            np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-5, err_msg=name)
            assert float(got_t.abs().max()) > 1.0, name
        else:
            assert float(got_t.abs().max()) < 1e-9 and float(np.abs(np.asarray(want_t)).max()) < 1e-9, name


def test_head_plan_at_model_7():
    """The head's geometry ``chip_smoke.py`` [precision] prints for model_7's
    1024 -> 10 (B = 128, S = 10) on the H100's 132 SMs: dparams_plan's 10
    runs of one sample, each a rank, 32 input blocks and the bias block: 33
    clusters of 10 (not portable) of 64 threads, two 64-row chunks a sample,
    no partials."""
    plan = sd.dparams_bf16_plan(10, 128, 1024, 10, 132)
    assert (plan.narrow, plan.n_split, plan.ranks, plan.grid, plan.chunks, plan.scratch) == (
        True, 10, 10, (33, 1, 10), 2, ())
    assert sd.dparams_bf16_head_runs(plan) == [range(r, r + 1) for r in range(10)]


@pytest.fixture(scope="module")
def narrow_partials_library(tmp_path_factory):
    names = tuple(f"{name}_partials" for name in emulation.DPARAMS_BF16)
    return emulation.build(tmp_path_factory, "sampled_dense_dparams_bf16_narrow_partials.cu", names,
                           directory=COMPARISON)


@pytest.mark.parametrize("shape", [(37, 70, 10, 3), (1, 70, 13, 1)], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_narrow_partials_design_still_builds_and_meets_the_twins(narrow_partials_library, shape):
    """The earlier design on dparams_plan's narrow geometry (partial planes
    and the f32 kernel's sum pass) against the bf16 twins, both instances."""
    b, i, o, s = shape
    g, x, xs, rho, brho = emulation.dparams_case(shape)
    plan = sd.dparams_plan(s, i, o, 132)
    for inp, name in ((x, "sampled_dense_dparams_bf16_partials"), (xs, "sampled_dense_xs_dparams_bf16_partials")):
        outs = [torch.full((i, o), float("nan")) for _ in range(2)] + [torch.full((o,), float("nan")) for _ in range(2)]
        partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
        err = getattr(narrow_partials_library, name)(
            g.data_ptr(), inp.data_ptr(), rho.data_ptr(), brho.data_ptr(),
            partials.data_ptr() if partials is not None else None, *(t.data_ptr() for t in outs), s, b, i, o, SEED,
            plan.n_split, None)
        assert err == 0
        emulation.check_dparams_bf16(tuple(outs), g, inp, rho, brho, s)
