"""Sampled dense layers with in-kernel noise (port of ``robustbnns_tpu/ops/sampled_dense.py``).

``y[s] = x @ W_s + b_s`` with ``W_s = loc + softplus(rho)·eps_s`` and
``b_s = bloc + softplus(brho)·eps_{b,s}``: S reparameterized draws of a dense
layer applied to a batch, without the ``(S, I, O)`` sampled weights ever
reaching device memory. The per-sample-input variant takes ``xs`` (S, B, I),
as the hidden layers of the fused predictive do.

Six hand-written CUDA kernels carry the op and its whole backward (``csrc/``):

=============================  ================================  ===============================
wrapper                        replaces (Pallas)                 computes
=============================  ================================  ===============================
``sampled_dense_fwd``          ``_fwd_kernel`` ``:99``           out[s] = x @ W_s + b_s
``sampled_dense_dx``           ``_bwd_dx_kernel`` ``:114``       dx = Σ_s g_s W_sᵀ
``sampled_dense_dparams``      ``_bwd_dparams_kernel`` ``:137``  dloc, drho, dbloc, dbrho
``sampled_dense_xs_fwd``       ``_fwd_kernel_xs`` ``:347``       out[s] = xs[s] @ W_s + b_s
``sampled_dense_xs_dx``        ``_bwd_xs_dx_kernel`` ``:362``    dxs[s] = g_s W_sᵀ
``sampled_dense_xs_dparams``   ``_bwd_xs_dparams_kernel`` ``:383``  as dparams, xs[s] for x
=============================  ================================  ===============================

The parameter cotangents, with dW_s = x_sᵀ g_s: dloc = Σ_s dW_s,
drho = Σ_s dW_s ⊙ eps_s ⊙ σ(rho), dbloc = Σ_s Σ_b g_s and
dbrho = Σ_s (Σ_b g_s) ⊙ eps[s, I] ⊙ σ(brho).

Noise: ``eps[s, i, o]`` is a pure function of (seed, s, i, o) — Philox4x32-10
with key (seed, 0) and counter (o >> 2, i, s, 0), the JAX kernel's mantissa
splice into uniforms and a full Box-Muller pair per two words — with the bias
at row ``i = I``. The stream is not the TPU's (that one depends on its tiling);
it is the same in every kernel here and in the plain twins, which compute it
with int64 tensor arithmetic.

``ROBUSTBNNS_KERNEL_PRECISION=default``, read at every call as the JAX package
reads it (``_dot_precision``, ``sampled_dense.py:44-65``), routes every wrapper
to its bf16 variant (counted as ``<wrapper>_bf16``): the forward kernels of
``csrc/sampled_dense_xs_bf16.cu`` (shared and per-sample input,
:func:`xs_bf16_plan`), the input-gradient kernels of
``csrc/sampled_dense_dx_bf16.cu`` (summed over samples, :func:`dx_bf16_plan`) and
``csrc/sampled_dense_xs_bf16.cu`` (per sample) round x (or g) and W_s to
bf16, the parameter-gradient kernels of ``csrc/sampled_dense_dparams_bf16.cu``
(:func:`dparams_bf16_plan`)
round x and g (dW_s = bf16(x_s)ᵀ bf16(g_s)); products on the tensor cores summed
in f32, f32 outputs; the noise, W_s in f32 and the bias as above (dbloc and
dbrho from the unrounded g, as JAX's ``jnp.sum`` is no ``_dot``). Their twins
round the same operands and multiply them in f32.

:func:`sampled_dense_reference` is the op with independent ``torch.randn``
draws, the yardstick for the kernels' noise statistics; it launches no kernel.

Each wrapper launches its kernel for CUDA tensors (or raises), and runs its
plain PyTorch twin for CPU tensors only (:func:`_sampled_dense_launch`, on
:mod:`.build`'s launch path). Each counts its kernel launches in the counter
``sampled_dense.<wrapper>`` (:func:`launch_counts`). The
autograd backward launches the dx kernel only when the input's gradient is
asked for and the dparams kernel only when a parameter's is, as the JAX VJP
splits them into two ``pallas_call``s that XLA can drop one by one
(``sampled_dense.py:252-254``).
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from robustbnns_tpu_torch.ops import build
from robustbnns_tpu_torch.utils.timing import reset_counters

_MASK = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(6.283185307179586))

# --------------------------------------------------------------------------- #
# Plain PyTorch twins: the same noise and arithmetic as the kernels
# --------------------------------------------------------------------------- #


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 words.

    The 32x32 -> 64-bit products wrap in signed int64; the high word is then
    ``(p >> 32) & 0xFFFFFFFF`` and the low word ``p & 0xFFFFFFFF``.
    """
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK
            k1 = (k1 + 0xBB67AE85) & _MASK
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (
            ((p1 >> 32) & _MASK) ^ c1 ^ k0,
            p1 & _MASK,
            ((p0 >> 32) & _MASK) ^ c3 ^ k1,
            p0 & _MASK,
        )
    return c0, c1, c2, c3


def _unit_from_bits(r: torch.Tensor) -> torch.Tensor:
    """[1, 2) floats from the top 23 bits of each word (``sampled_dense.py:86-87``)."""
    return ((r >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def _box_muller(a, b):
    u1 = 2.0 - _unit_from_bits(a)  # (0, 1]: log-safe
    rad = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI_F32 * (_unit_from_bits(b) - 1.0)
    return rad * torch.cos(theta), rad * torch.sin(theta)


def sampled_noise(seed: int, n_samples: int, n_rows: int, o_dim: int, device) -> torch.Tensor:
    """``eps[s, i, o]`` for ``i < n_rows``, shape (S, n_rows, O). Row ``I`` of an
    (I, O) layer is its bias row, so the forward asks for ``I + 1`` rows."""
    quads = -(-o_dim // 4)
    shape = (n_samples, n_rows, quads)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    c0 = ar(quads).view(1, 1, -1).expand(shape)
    c1 = ar(n_rows).view(1, -1, 1).expand(shape)
    c2 = ar(n_samples).view(-1, 1, 1).expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    r0, r1, r2, r3 = philox4x32_10(c0, c1, c2, c3, int(seed) & _MASK, 0)
    z0, z1 = _box_muller(r0, r1)
    z2, z3 = _box_muller(r2, r3)
    return torch.stack([z0, z1, z2, z3], dim=-1).reshape(n_samples, n_rows, 4 * quads)[..., :o_dim]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))``, the form of ``jax.nn.softplus`` and of the kernels."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def sampled_weights(loc, rho, bloc, brho, n_samples: int, seed: int):
    """The S draws ``(W (S, I, O), b (S, O))`` the kernels generate on chip."""
    i_dim, o_dim = loc.shape
    eps = sampled_noise(seed, n_samples, i_dim + 1, o_dim, loc.device)
    return loc + softplus(rho) * eps[:, :i_dim], bloc + softplus(brho) * eps[:, i_dim]


def _sampled_w(loc, rho, n_samples: int, seed: int):
    eps = sampled_noise(seed, n_samples, loc.shape[0], loc.shape[1], loc.device)
    return loc + softplus(rho) * eps


def sampled_dense_fwd_plain(x, loc, rho, bloc, brho, n_samples: int, seed: int):
    w, b = sampled_weights(loc, rho, bloc, brho, n_samples, seed)
    return torch.matmul(x, w) + b[:, None, :]


def sampled_dense_dx_plain(g, loc, rho, n_samples: int, seed: int):
    return torch.matmul(g, _sampled_w(loc, rho, n_samples, seed).transpose(1, 2)).sum(0)


# torch.matmul broadcasts a shared (B, I) input and a per-sample (S, B, I) one alike
sampled_dense_xs_fwd_plain = sampled_dense_fwd_plain


def sampled_dense_xs_dx_plain(g, loc, rho, n_samples: int, seed: int):
    return torch.matmul(g, _sampled_w(loc, rho, n_samples, seed).transpose(1, 2))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even) and back to f32."""
    return t.to(torch.bfloat16).float()


def _dparams_plain(g, x, rho, brho, n_samples: int, seed: int, round_operands: bool):
    i_dim = rho.shape[0]
    eps = sampled_noise(seed, n_samples, i_dim + 1, rho.shape[1], rho.device)
    xr, gr = (_bf16(x), _bf16(g)) if round_operands else (x, g)
    dw = torch.matmul(xr.transpose(-1, -2), gr)  # (S, I, O): x_sᵀ g_s
    db = g.sum(1)  # (S, O), from the unrounded g in both precisions
    return (
        dw.sum(0),
        (dw * eps[:, :i_dim] * torch.sigmoid(rho)).sum(0),
        db.sum(0),
        (db * eps[:, i_dim] * torch.sigmoid(brho)).sum(0),
    )


def sampled_dense_dparams_plain(g, x, rho, brho, n_samples: int, seed: int):
    """``(dloc, drho, dbloc, dbrho)`` from the formulas of the Pallas kernels
    (``sampled_dense.py:153-167``), written out: autograd through
    :func:`softplus` would give a kink at 0 where σ(rho) has none."""
    return _dparams_plain(g, x, rho, brho, n_samples, seed, round_operands=False)


# x (B, I) broadcasts against g (S, B, O) as xs (S, B, I) does (``:400-414``)
sampled_dense_xs_dparams_plain = sampled_dense_dparams_plain


def sampled_dense_fwd_bf16_plain(x, loc, rho, bloc, brho, n_samples: int, seed: int):
    """The bf16 kernels' function: the f32 twin's W_s and b_s, then
    bf16(x) @ bf16(W_s) in f32 (each product of two bf16 values is exact in
    f32) + b_s."""
    w, b = sampled_weights(loc, rho, bloc, brho, n_samples, seed)
    return torch.matmul(_bf16(x), _bf16(w)) + b[:, None, :]


def sampled_dense_dx_bf16_plain(g, loc, rho, n_samples: int, seed: int):
    return torch.matmul(_bf16(g), _bf16(_sampled_w(loc, rho, n_samples, seed)).transpose(1, 2)).sum(0)


sampled_dense_xs_fwd_bf16_plain = sampled_dense_fwd_bf16_plain


def sampled_dense_xs_dx_bf16_plain(g, loc, rho, n_samples: int, seed: int):
    return torch.matmul(_bf16(g), _bf16(_sampled_w(loc, rho, n_samples, seed)).transpose(1, 2))


def sampled_dense_dparams_bf16_plain(g, x, rho, brho, n_samples: int, seed: int):
    """The bf16 dparams kernels' function: dW_s = bf16(x_s)ᵀ bf16(g_s) in f32
    (each product exact), then the f32 twin's formulas; dbloc and dbrho are
    the f32 twin's, bit for bit."""
    return _dparams_plain(g, x, rho, brho, n_samples, seed, round_operands=True)


sampled_dense_xs_dparams_bf16_plain = sampled_dense_dparams_bf16_plain


def bf16_error_scale(kind: str, a, loc, rho, n_samples: int, seed: int, largest: bool = False):
    """Per output of ``kind`` (``fwd``, ``xs_fwd``, ``dx``, ``xs_dx``), the sum
    over its contraction of |a|·|W_s| (``a`` is x, xs or g), or with
    ``largest`` the largest single term. Rounding both operands of every
    product to bf16 (unit roundoff 2⁻⁸) moves the output by at most about
    2·2⁻⁸ of the sum; a W_s that rounds to the other bf16 neighbour moves one
    term by at most 2⁻⁷ of its own |a|·|W_s|, so at most 2⁻⁷ of the largest.

    For ``dparams`` and ``xs_dparams`` the arguments are the wrapper's,
    ``a`` = g and ``loc`` = the layer input x (xs), and the result is the pair
    (dloc's scale, drho's scale): Σ_s Σ_b |x_sbi||g_sbo|, and the same terms
    weighted by |eps_s|·σ(rho). No W_s is rounded there, so ``largest`` does
    not apply; the bias takes no product and has no scale."""
    if kind in ("dparams", "xs_dparams"):
        if largest:
            raise ValueError("the dparams kinds round no W_s: no largest-term scale")
        eps = sampled_noise(seed, n_samples, rho.shape[0], rho.shape[1], rho.device).abs()
        terms = torch.matmul(loc.abs().transpose(-1, -2), a.abs())  # (S, I, O): Σ_b |x_sbi||g_sbo|
        return terms.sum(0), (terms * eps * torch.sigmoid(rho)).sum(0)
    w, a = _sampled_w(loc, rho, n_samples, seed).abs(), a.abs()
    fwd = kind in ("fwd", "xs_fwd")
    if not largest:
        out = torch.matmul(a, w if fwd else w.transpose(1, 2))
        return out.sum(0) if kind == "dx" else out
    rows = []  # one sample, 256 rows at a time: (rows, I, O) products
    for s in range(n_samples):
        a_s = a if a.dim() == 2 else a[s]
        rows.append(torch.cat([(c[:, :, None] * w[s]).amax(1) if fwd else (c[:, None, :] * w[s]).amax(2)
                               for c in a_s.split(256)]))
    out = torch.stack(rows)
    return out.amax(0) if kind == "dx" else out


def kernel_precision_default() -> bool:
    """``ROBUSTBNNS_KERNEL_PRECISION=default``: the bf16 variants (read per call)."""
    return os.environ.get("ROBUSTBNNS_KERNEL_PRECISION") == "default"


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# entry point (each wrapper's name) -> (its source, its argument types, the stream last)
SIGNATURES = {
    "sampled_dense_fwd": ("sampled_dense_fwd.cu", (_P,) * 8 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_fwd": ("sampled_dense_fwd.cu", (_P,) * 8 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_dx": ("sampled_dense_dx.cu", (_P,) * 6 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_dx": ("sampled_dense_dx.cu", (_P,) * 6 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_dparams": ("sampled_dense_dparams.cu", (_P,) * 9 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_dparams": ("sampled_dense_dparams.cu", (_P,) * 9 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_fwd_bf16": ("sampled_dense_xs_bf16.cu", (_P,) * 8 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_fwd_bf16": ("sampled_dense_xs_bf16.cu", (_P,) * 8 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_dx_bf16": ("sampled_dense_dx_bf16.cu", (_P,) * 6 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_dx_bf16": ("sampled_dense_xs_bf16.cu", (_P,) * 6 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_dparams_bf16": ("sampled_dense_dparams_bf16.cu", (_P,) * 9 + (_I,) * 4 + (_U, _I, _P)),
    "sampled_dense_xs_dparams_bf16": ("sampled_dense_dparams_bf16.cu", (_P,) * 9 + (_I,) * 4 + (_U, _I, _P)),
}


def _check_params(loc, rho, bloc=None, brho=None) -> None:
    if loc.dim() != 2 or rho.shape != loc.shape:
        raise ValueError(f"loc/rho must be (I, O) of one shape, got {loc.shape}, {rho.shape}")
    for v in (bloc, brho):
        if v is not None and v.shape != loc.shape[1:]:
            raise ValueError(f"bloc/brho must be (O,) = {loc.shape[1:]}, got {v.shape}")


def _check_input(x, loc, rho, bloc, brho, n_samples) -> None:
    """A forward's input: x (B, I), or xs (S, B, I) where ``n_samples`` is given."""
    _check_params(loc, rho, bloc, brho)
    if n_samples is None and (x.dim() != 2 or x.shape[1] != loc.shape[0]):
        raise ValueError(f"x must be (B, I={loc.shape[0]}), got {tuple(x.shape)}")
    if n_samples is not None and (x.dim() != 3 or x.shape[0] != n_samples or x.shape[2] != loc.shape[0]):
        raise ValueError(f"xs must be (S={n_samples}, B, I={loc.shape[0]}), got {tuple(x.shape)}")


def _check_cotangent(g, loc, rho, n_samples: int) -> None:
    """An input gradient's cotangent g (S, B, O)."""
    _check_params(loc, rho)
    if g.dim() != 3 or g.shape[0] != n_samples or g.shape[2] != loc.shape[1]:
        raise ValueError(f"g must be (S={n_samples}, B, O={loc.shape[1]}), got {tuple(g.shape)}")


def _sampled_dense_launch(wrapper, plain, operands: tuple, n_samples: int, seed: int, buffers):
    """``plain`` on CPU tensors; else the kernel named as ``wrapper`` (its C
    entry point), counted in ``sampled_dense.<wrapper>``. ``operands`` lead
    with x, xs or g and hold rho (I, O) third; ``buffers(device, S, B, I, O,
    sms)`` plans the call and gives ``(n_split, result, tensors)``, the
    launch's arguments after the operands in ``tensors``."""
    if not build.check("sampled-dense", operands):
        return plain(*operands, n_samples, seed)
    device, b_dim, (i_dim, o_dim) = operands[0].device, operands[0].shape[-2], operands[2].shape
    n_split, result, tensors = buffers(device, n_samples, b_dim, i_dim, o_dim, build.sm_count(device))
    name = wrapper.__name__
    build.launch("sampled_dense." + name, build.bind(SIGNATURES[name][0], name, SIGNATURES[name][1]), device,
                 *operands, *tensors, n_samples, b_dim, i_dim, o_dim, seed & _MASK, n_split)
    return result


def _scratch(plan, device):
    """The plan's partials, or None where it has none."""
    return torch.empty(plan.scratch, device=device) if plan.scratch else None


# Geometry of the dx kernels (csrc/sampled_dense_dx.cu): a wide block owns 128
# batch rows x 64 inputs with 128 threads (four fit on an SM) and walks work
# units (s, c), c a chunk of 16 outputs; O <= 16 takes the narrow path, 128
# rows x 32 inputs a block.
DX_ROWS, DX_COLS, DX_DEPTH, DX_BLOCKS_PER_SM, DX_MAX_SPLIT = 128, 64, 16, 4, 48
NARROW_MAX_O, NARROW_COLS, NARROW_ROWS = 16, 32, 128


@dataclass(frozen=True)
class DxPlan:
    """Launch geometry of one dx call.

    ``n_split``: runs per output tile. dx splits the tile's S·C work units into
    ``n_split`` runs and sums their partial tiles; dxs splits each sample's C
    chunks into ``n_split`` runs. ``scratch``: the partials' shape, ``()``
    when a block writes its tile to the output itself.
    """

    narrow: bool
    n_split: int
    grid: tuple[int, int, int]
    scratch: tuple[int, ...]
    units: int  # S * C, the work units of one output tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dx_plan(n_samples: int, b_dim: int, i_dim: int, o_dim: int, sms: int, sum_samples: bool) -> DxPlan:
    """Where each (s, o-chunk) of the dx kernels runs, for a card with ``sms`` SMs.

    The wide path splits each tile's work until the grid fills the SMs'
    ``DX_BLOCKS_PER_SM`` slots: dx into at most :data:`DX_MAX_SPLIT` runs,
    whatever S is; dxs only while it has fewer than three blocks an SM, so
    its partials stay within about ``2·DX_BLOCKS_PER_SM·sms`` tiles.
    """
    chunks = _cdiv(o_dim, DX_DEPTH)
    units = n_samples * chunks
    if o_dim <= NARROW_MAX_O:
        grid = (_cdiv(i_dim, NARROW_COLS), 1 if sum_samples else n_samples, _cdiv(b_dim, NARROW_ROWS))
        return DxPlan(True, 1, grid, (), units)
    tiles = _cdiv(i_dim, DX_COLS) * _cdiv(b_dim, DX_ROWS)
    if sum_samples:
        n_split = max(1, min(units, DX_MAX_SPLIT, DX_BLOCKS_PER_SM * sms // tiles))
        rows, scratch = n_split, (n_split, b_dim, i_dim)
    else:
        tasks = tiles * n_samples
        n_split = 1 if tasks >= 3 * sms else min(chunks, _cdiv(3 * sms, tasks))
        rows, scratch = n_samples * n_split, (n_split, n_samples, b_dim, i_dim)
    grid = (_cdiv(i_dim, DX_COLS), rows, _cdiv(b_dim, DX_ROWS))
    return DxPlan(False, n_split, grid, scratch if n_split > 1 else (), units)


def dx_unit_runs(plan: DxPlan, n_samples: int, sum_samples: bool) -> list[range]:
    """The work units ``s * C + c`` of one output tile, per block row, as the
    wide kernel computes them: dx splits all S·C units into ``n_split`` runs,
    dxs the C chunks of each sample (block row ``s * n_split + run``)."""
    if sum_samples:
        return [range(plan.units * y // plan.n_split, plan.units * (y + 1) // plan.n_split)
                for y in range(plan.n_split)]
    chunks = plan.units // n_samples
    return [range(s * chunks + chunks * y // plan.n_split, s * chunks + chunks * (y + 1) // plan.n_split)
            for s in range(n_samples) for y in range(plan.n_split)]


# Geometry of the forward kernels (csrc/sampled_dense_fwd.cu): a wide block
# owns 128 batch rows x 64 outputs of one sample with 128 threads (four fit on
# an SM) and walks chunks of 16 inputs; O <= 16 takes the narrow path, 128
# rows a block and chunks of 32 inputs.
FWD_ROWS, FWD_COLS, FWD_DEPTH, FWD_BLOCKS_PER_SM, FWD_NARROW_DEPTH = 128, 64, 16, 4, 32


@dataclass(frozen=True)
class FwdPlan:
    """Launch geometry of one forward call.

    ``n_split``: runs per output tile; run ``r`` walks the chunks
    ``fwd_chunk_runs(plan)[r]`` of I and, when ``n_split > 1``, writes a partial
    tile that a second pass sums in the order 0 .. n_split-1. ``grid``: (S ·
    n_split, output tiles, row tiles). ``scratch``: the partials' shape, ``()``
    when a block writes its tile to the output itself.
    """

    narrow: bool
    n_split: int
    grid: tuple[int, int, int]
    scratch: tuple[int, ...]
    chunks: int  # C, the chunks of I of one output tile


def fwd_plan(n_samples: int, b_dim: int, i_dim: int, o_dim: int, sms: int) -> FwdPlan:
    """Where each chunk of I of the forward kernels runs, for a card with ``sms`` SMs.

    A tile is (sample, row tile, output tile): the grid has S · row tiles ·
    output tiles of them. While they fill fewer than the SMs'
    ``FWD_BLOCKS_PER_SM`` slots, each tile's chunks of I are split into as
    many runs as fit in one wave of those slots, so the partials never exceed
    ``FWD_BLOCKS_PER_SM · sms`` tiles whatever S and B are.
    """
    narrow = o_dim <= NARROW_MAX_O
    chunks = _cdiv(i_dim, FWD_NARROW_DEPTH if narrow else FWD_DEPTH)
    o_tiles = 1 if narrow else _cdiv(o_dim, FWD_COLS)
    b_tiles = _cdiv(b_dim, FWD_ROWS)
    tiles = n_samples * o_tiles * b_tiles
    n_split = max(1, min(chunks, FWD_BLOCKS_PER_SM * sms // tiles))
    scratch = (n_split, n_samples, b_dim, o_dim) if n_split > 1 else ()
    return FwdPlan(narrow, n_split, (n_samples * n_split, o_tiles, b_tiles), scratch, chunks)


def fwd_chunk_runs(plan: FwdPlan) -> list[range]:
    """The chunks of I that each run of a tile walks, as the kernels compute them."""
    c, n = plan.chunks, plan.n_split
    return [range(c * r // n, c * (r + 1) // n) for r in range(n)]


# Geometry of the dparams kernels (csrc/sampled_dense_dparams.cu): a wide block
# owns 128 inputs x 64 outputs of dloc/drho with 128 threads (two fit on an SM:
# 88.5 KB of shared memory each) and walks a run of samples, the runs of a tile
# one cluster of at most DP_MAX_RUNS blocks; O <= 16 takes the narrow path, 32
# inputs a block (four an SM counted).
DP_ROWS, DP_COLS, DP_BLOCKS_PER_SM, DP_MAX_RUNS = 128, 64, 2, 8
DP_NARROW_COLS, DP_NARROW_BLOCKS_PER_SM = 32, 4


@dataclass(frozen=True)
class DparamsPlan:
    """Launch geometry of one dparams call.

    ``n_split``: runs per tile of dloc/drho; run ``r`` walks the samples
    ``dparams_sample_runs(plan, S)[r]``. The wide path's runs of a tile are
    one thread-block cluster that sums them on chip in the order
    0 .. n_split-1; the narrow path's runs, when ``n_split > 1``, write two
    partial planes (bias in row I) that a second pass sums in that order.
    ``grid``: (output tiles, input tiles, runs) on the wide path, (input
    blocks, runs, 1) on the narrow one. ``scratch``: the partials' shape,
    ``()`` when there are none.
    """

    narrow: bool
    n_split: int
    grid: tuple[int, int, int]
    scratch: tuple[int, ...]


def dparams_plan(n_samples: int, i_dim: int, o_dim: int, sms: int) -> DparamsPlan:
    """Where each sample of the dparams kernels runs, for a card with ``sms`` SMs.

    The tiles of dloc/drho do not grow with S or B. While they fill less than
    one wave of the SMs' block slots, each tile's samples are split into as
    many runs as fit in that wave (at most :data:`DP_MAX_RUNS`, a cluster, on
    the wide path), so the narrow path's partials never exceed one wave of
    tiles whatever S and B are (B does not enter: a block walks the whole
    batch).
    """
    if o_dim <= NARROW_MAX_O:
        blocks = _cdiv(i_dim, DP_NARROW_COLS)
        n_split = max(1, min(n_samples, DP_NARROW_BLOCKS_PER_SM * sms // blocks))
        scratch = (n_split, 2, i_dim + 1, o_dim) if n_split > 1 else ()
        return DparamsPlan(True, n_split, (blocks, n_split, 1), scratch)
    o_tiles, i_tiles = _cdiv(o_dim, DP_COLS), _cdiv(i_dim, DP_ROWS)
    n_split = max(1, min(n_samples, DP_MAX_RUNS, DP_BLOCKS_PER_SM * sms // (o_tiles * i_tiles)))
    return DparamsPlan(False, n_split, (o_tiles, i_tiles, n_split), ())


def dparams_sample_runs(plan, n_samples: int) -> list[range]:
    """The samples that each run of a tile walks, as the kernels compute them
    (``plan``: a :class:`DparamsPlan` or :class:`DparamsBf16Plan`)."""
    n = plan.n_split
    return [range(n_samples * r // n, n_samples * (r + 1) // n) for r in range(n)]


# The bf16 dparams kernels (csrc/sampled_dense_dparams_bf16.cu) take
# dparams_plan's split: the wide kernel's block of 256 threads owns the same
# 128 x 64 tile, two blocks an SM (at most 128 registers a thread, 107.5 KB of
# shared memory), and walks the 32-row chunks of a run of samples; the head
# (O <= 16) gives a block of 64 threads 32 inputs and the samples of a rank,
# 64 rows a chunk, the ranks of an input block one cluster of at most
# DP_HEAD_MAX_RANKS (non-portable above 8).
DP_BF16_DEPTH, DP_BF16_EPS_ITEMS = 32, 8
DP_HEAD_COLS, DP_HEAD_DEPTH, DP_HEAD_MAX_RANKS = 32, 64, 16


@dataclass(frozen=True)
class DparamsBf16Plan:
    """Launch geometry of one call of a bf16 dparams kernel.

    ``n_split``: :func:`dparams_plan`'s runs of samples (the bias sums over
    them, so dbloc and dbrho stay bit-equal to the f32 kernel's). Wide path:
    ``grid`` (output tiles, input tiles, runs), the runs of a tile one cluster
    (``ranks`` = n_split), ``chunks`` the 32-row chunks of a sample. Head
    (``narrow``): ``grid`` (input blocks + 1, 1, ranks), the last block x
    the bias row's, the ``ranks`` = min(n_split, :data:`DP_HEAD_MAX_RANKS`)
    blocks of an input block (or of the bias) one cluster, rank k holding
    runs ``dparams_bf16_head_runs(plan)[k]``; ``chunks`` the 64-row chunks
    of a sample. No partials on either path.
    """

    narrow: bool
    n_split: int
    grid: tuple[int, int, int]
    scratch: tuple[int, ...]
    chunks: int
    ranks: int


def dparams_bf16_plan(n_samples: int, b_dim: int, i_dim: int, o_dim: int, sms: int) -> DparamsBf16Plan:
    """Where each sample and chunk of the bf16 dparams kernels runs, for a card
    with ``sms`` SMs: :func:`dparams_plan`'s runs of samples, so the bf16 and
    the f32 kernels sum the bias over the same runs and dbloc and dbrho stay
    bit-equal; its wide tiles and grid; on the head, its runs grouped into at
    most :data:`DP_HEAD_MAX_RANKS` ranks of one cluster (model_7's 1024 -> 10
    on 132 SMs: 10 runs of one sample, 32 input clusters of 10 and the
    bias's)."""
    plan = dparams_plan(n_samples, i_dim, o_dim, sms)
    if not plan.narrow:
        return DparamsBf16Plan(False, plan.n_split, plan.grid, (), _cdiv(b_dim, DP_BF16_DEPTH), plan.n_split)
    ranks = min(plan.n_split, DP_HEAD_MAX_RANKS)
    return DparamsBf16Plan(True, plan.n_split, (_cdiv(i_dim, DP_HEAD_COLS) + 1, 1, ranks), (),
                           _cdiv(b_dim, DP_HEAD_DEPTH), ranks)


def dparams_bf16_head_runs(plan: DparamsBf16Plan) -> list[range]:
    """The runs of samples (of :func:`dparams_sample_runs`) that each rank of
    a head cluster holds, in order, as the kernel computes them."""
    n, k = plan.n_split, plan.ranks
    return [range(n * r // k, n * (r + 1) // k) for r in range(k)]


def dparams_bf16_units(plan: DparamsBf16Plan, n_samples: int) -> list[list[tuple[int, int, range]]]:
    """Per run of a wide tile, its units as the kernel walks them: (sample,
    chunk, the lane's eps quads drawn with that chunk). Each lane draws the
    8 Philox quads of a sample that its accumulators hold, quad k with the
    sample's chunk c where 8c / C <= k < 8(c + 1) / C."""
    c_dim, k_dim = plan.chunks, DP_BF16_EPS_ITEMS
    return [[(s, c, range(k_dim * c // c_dim, k_dim * (c + 1) // c_dim)) for s in run for c in range(c_dim)]
            for run in dparams_sample_runs(plan, n_samples)]


# Geometry of the bf16 kernels of csrc/sampled_dense_xs_bf16.cu (xs_fwd, xs_dx and fwd): a
# block of 256 threads owns 128 batch rows x 64 columns of one sample (three
# fit on an SM: at most 80 registers a thread, 64 KB of shared memory) and
# walks a run of 16-deep chunks of the contraction; the runs of a tile are one
# cluster of at most XS_MAX_RUNS. O <= 16 takes the heads' tiles: the forward
# 128 x 16, dx 128 x 64 over the one chunk of O.
XS_ROWS, XS_COLS, XS_DEPTH, XS_BLOCKS_PER_SM, XS_MAX_RUNS = 128, 64, 16, 3, 8
XS_NARROW_COLS, XS_NARROW_FWD_DEPTH = 16, 64
XS_RUN_OVERHEAD = 4  # chunks' worth of a run's two unhidden first chunks and its cluster sum


@dataclass(frozen=True)
class XsBf16Plan:
    """Launch geometry of one call of a bf16 per-sample kernel.

    ``grid``: (column tiles, S, row tiles · n_split); the ``n_split`` runs of a
    tile are one thread-block cluster along z (rank r walks
    ``xs_bf16_chunk_runs(plan)[r]``) that sums them on chip in the order
    0 .. n_split-1. ``softplus_scratch``: the wide path reads softplus(rho)
    from an (I, O) scratch; the heads compute it inline. No partials.
    """

    narrow: bool
    n_split: int
    grid: tuple[int, int, int]
    cols: int  # columns of a tile: O for the forward, I for dx
    depth: int  # contraction a chunk: I for the forward, O for dx
    chunks: int
    softplus_scratch: bool


def xs_bf16_plan(n_samples: int, b_dim: int, i_dim: int, o_dim: int, sms: int, kind: str) -> XsBf16Plan:
    """Where each chunk of the bf16 kernel ``kind`` of ``sampled_dense_xs_bf16.cu``
    (``"fwd"``: xs_fwd, and fwd, whose shared x is xs with sample stride 0;
    ``"dx"``: xs_dx) runs, for a card with ``sms`` SMs.

    A tile is (column tile, sample, row tile). When the tiles fill the SMs'
    ``XS_BLOCKS_PER_SM`` slots, one run a tile. Otherwise each tile's chunks
    are split into the n <= :data:`XS_MAX_RUNS` runs that minimise the
    blocks' share of the slots (at least one wave) times a run's length (its
    chunks plus :data:`XS_RUN_OVERHEAD`), the smallest n on a tie: at
    model_7's hidden layer 3 runs, measured 1.5-3% faster than 2 and 4 on the
    H100 (``scripts/torch_dx_probe.py --xs-bf16``).
    """
    if kind not in ("fwd", "dx"):
        raise ValueError(f"kind must be 'fwd' or 'dx', got {kind!r}")
    narrow = o_dim <= NARROW_MAX_O
    k_dim, n_dim = (i_dim, o_dim) if kind == "fwd" else (o_dim, i_dim)
    head_fwd = narrow and kind == "fwd"
    cols, depth = (XS_NARROW_COLS, XS_NARROW_FWD_DEPTH) if head_fwd else (XS_COLS, XS_DEPTH)
    chunks = _cdiv(k_dim, depth)
    col_tiles, b_tiles = _cdiv(n_dim, cols), _cdiv(b_dim, XS_ROWS)
    tiles, slots = col_tiles * n_samples * b_tiles, XS_BLOCKS_PER_SM * sms
    n_split = 1
    if tiles < slots:
        cost = lambda n: max(1.0, tiles * n / slots) * (_cdiv(chunks, n) + XS_RUN_OVERHEAD)  # noqa: E731
        n_split = min(range(1, min(XS_MAX_RUNS, chunks) + 1), key=lambda n: (cost(n), n))
    return XsBf16Plan(narrow, n_split, (col_tiles, n_samples, b_tiles * n_split), cols, depth, chunks,
                      not narrow)


def xs_bf16_chunk_runs(plan: XsBf16Plan) -> list[range]:
    """The chunks that each run of a tile walks, as the kernels compute them."""
    c, n = plan.chunks, plan.n_split
    return [range(c * r // n, c * (r + 1) // n) for r in range(n)]


# Geometry of the bf16 dx kernel (csrc/sampled_dense_dx_bf16.cu): a block of 4
# MMA warps and 16 draw warps (640 threads, one an SM: 184 KB of shared
# memory) owns 128 batch rows x 64 inputs of dx and walks a run of units
# (64-deep chunk c of O, 16-deep when O <= 16; sample s) in the order
# c * S + s; the runs of a tile form clusters of at most DXB_MAX_CLUSTER
# blocks (pairs: at one block an SM the H100 holds 66 pairs at once, but 22
# clusters of 5 and 15 of 8), whose sums a short pass adds when a tile has
# more than one.
DXB_ROWS, DXB_COLS, DXB_DEPTH, DXB_NARROW_DEPTH = 128, 64, 64, 16
DXB_BLOCKS_PER_SM, DXB_MAX_CLUSTER, DXB_MAX_SPLIT = 1, 2, 32
DXB_RUN_OVERHEAD = 4  # units' worth of a run's pipeline fill and its cluster sum
DXB_PASS_OVERHEAD = 1  # units' worth of the pass over the clusters' partial tiles, a partial tile


@dataclass(frozen=True)
class DxBf16Plan:
    """Launch geometry of one call of the bf16 dx kernel.

    ``grid``: (input tiles, row tiles, n_split); run ``r`` of a tile walks the
    units ``dx_bf16_unit_runs(plan)[r]`` (unit ``c * S + s``: chunk c of O,
    ``depth`` deep, sample s). The runs form ``n_split // cluster`` clusters
    of ``cluster`` blocks along z; each sums its runs on chip in the order
    0 .. cluster-1 and, when a tile has more than one cluster, writes one
    partial tile of ``scratch`` that a pass sums in the order of the
    clusters. softplus(rho) is computed in the kernel, once a run's chunk.
    """

    narrow: bool
    n_split: int
    cluster: int
    grid: tuple[int, int, int]
    depth: int
    chunks: int
    units: int  # S * chunks, the units of one tile
    scratch: tuple[int, ...]


def dx_bf16_cluster(n_split: int) -> int:
    """The largest divisor of ``n_split`` up to :data:`DXB_MAX_CLUSTER`: the
    blocks of one cluster, as the kernel's launcher computes it."""
    return max(c for c in range(1, min(n_split, DXB_MAX_CLUSTER) + 1) if n_split % c == 0)


def dx_bf16_plan(n_samples: int, b_dim: int, i_dim: int, o_dim: int, sms: int) -> DxBf16Plan:
    """Where each unit (chunk of O, sample) of the bf16 dx kernel runs, for a
    card with ``sms`` SMs.

    A tile is (input tile, row tile), one block a run, one block an SM. Each
    tile's units are split into the n <= :data:`DXB_MAX_SPLIT` runs that
    minimise the blocks' share of the SMs (at least one wave) times a run's
    length (its units plus :data:`DXB_RUN_OVERHEAD`), plus
    :data:`DXB_PASS_OVERHEAD` a partial tile where the runs form more than
    one cluster, the smallest n on a tie. At model_7's first layer (784 ->
    1024, B = 128, S = 10, 132 SMs): 10 runs of 16 units, five pairs a tile.
    """
    narrow = o_dim <= NARROW_MAX_O
    depth = DXB_NARROW_DEPTH if narrow else DXB_DEPTH
    chunks = _cdiv(o_dim, depth)
    units = n_samples * chunks
    col_tiles, b_tiles = _cdiv(i_dim, DXB_COLS), _cdiv(b_dim, DXB_ROWS)
    tiles, slots = col_tiles * b_tiles, DXB_BLOCKS_PER_SM * sms

    def cost(n):
        clusters = n // dx_bf16_cluster(n)
        passes = DXB_PASS_OVERHEAD * clusters if clusters > 1 else 0
        return max(1.0, tiles * n / slots) * (_cdiv(units, n) + DXB_RUN_OVERHEAD) + passes

    n_split = min(range(1, min(DXB_MAX_SPLIT, units) + 1), key=lambda n: (cost(n), n))
    cluster = dx_bf16_cluster(n_split)
    scratch = (n_split // cluster, b_dim, i_dim) if n_split > cluster else ()
    return DxBf16Plan(narrow, n_split, cluster, (col_tiles, b_tiles, n_split), depth, chunks, units, scratch)


def dx_bf16_unit_runs(plan: DxBf16Plan) -> list[range]:
    """The units ``c * S + s`` that each run of a tile walks, in order, as
    the kernel computes them."""
    u, n = plan.units, plan.n_split
    return [range(u * r // n, u * (r + 1) // n) for r in range(n)]


def _dx_bf16_buffers(device, n_samples, b_dim, i_dim, o_dim, sms):
    """The kernel of ``sampled_dense_dx_bf16.cu`` on :func:`dx_bf16_plan`'s geometry."""
    plan = dx_bf16_plan(n_samples, b_dim, i_dim, o_dim, sms)
    out = torch.empty((b_dim, i_dim), device=device)
    return plan.n_split, out, (None, _scratch(plan, device), out)


def _xs_bf16_buffers(device, n_samples, b_dim, i_dim, o_dim, sms, kind: str):
    """The kernels of ``sampled_dense_xs_bf16.cu`` on :func:`xs_bf16_plan`'s
    geometry: ``kind`` ``"fwd"`` after xs or the shared x and loc, rho,
    bloc, brho; ``"dx"`` after g, loc and rho."""
    plan = xs_bf16_plan(n_samples, b_dim, i_dim, o_dim, sms, kind)
    out = torch.empty((n_samples, b_dim, o_dim if kind == "fwd" else i_dim), device=device)
    return plan.n_split, out, (torch.empty((i_dim, o_dim), device=device) if plan.softplus_scratch else None,
                               None, out)


def _fwd_buffers(device, n_samples, b_dim, i_dim, o_dim, sms):
    """The forward kernels on :func:`fwd_plan`'s geometry."""
    plan = fwd_plan(n_samples, b_dim, i_dim, o_dim, sms)
    out = torch.empty((n_samples, b_dim, o_dim), device=device)
    return plan.n_split, out, (None if plan.narrow else torch.empty((i_dim, o_dim), device=device),
                               _scratch(plan, device), out)


def _dx_buffers(device, n_samples, b_dim, i_dim, o_dim, sms, sum_samples: bool):
    """The input-gradient kernels on :func:`dx_plan`'s geometry; ``sum_samples``
    gives dx (B, I), else dxs (S, B, I)."""
    plan = dx_plan(n_samples, b_dim, i_dim, o_dim, sms, sum_samples)
    out = torch.empty((b_dim, i_dim) if sum_samples else (n_samples, b_dim, i_dim), device=device)
    return plan.n_split, out, (None if plan.narrow else torch.empty((i_dim, o_dim), device=device),
                               _scratch(plan, device), out)


def sampled_dense_fwd(x, loc, rho, bloc, brho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_fwd_kernel`` (``robustbnns_tpu/ops/sampled_dense.py:99``) ->
    ``csrc/sampled_dense_fwd.cu``. (B, I) -> (S, B, O).

    Bound on the H100: S·B·I·O exact-f32 FMAs on the FFMA pipe (1.03 G at the
    first layer of fc2-1024, B=128, S=10), plus S·I·O normals drawn in the
    kernel. Design (:func:`fwd_plan`): 128 x 64 output tiles of one sample, 8 x
    8 per thread, walk chunks of 16 inputs double-buffered through shared
    memory; while the grid is small each tile's chunks are split into runs
    whose partial tiles a second kernel sums in a fixed order (bit-identical
    from call to call). softplus(rho) is computed once per call into an (I, O)
    scratch; O <= 16 takes a narrow path that splits I over blocks. A call
    launches up to three CUDA kernels and counts one launch.
    """
    _check_input(x, loc, rho, bloc, brho, None)
    if kernel_precision_default():
        return sampled_dense_fwd_bf16(x, loc, rho, bloc, brho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_fwd, sampled_dense_fwd_plain, (x, loc, rho, bloc, brho), n_samples,
                                 seed, _fwd_buffers)


def sampled_dense_dx(g, loc, rho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_bwd_dx_kernel`` (``robustbnns_tpu/ops/sampled_dense.py:114``) ->
    ``csrc/sampled_dense_dx.cu``. g (S, B, O) -> dx (B, I) = Σ_s g_s W_sᵀ.

    Bound on the H100: S·B·I·O exact-f32 FMAs on the FFMA pipe (1.03 G at the
    first layer of fc2-1024, B=128, S=10), plus S·I·O normals drawn in the
    kernel, each feeding only B FMAs and costing about 57 instructions.
    Design (:func:`dx_plan`): 128 x 64 output tiles, 8 x 8 per thread, walk
    work units of 16 outputs double-buffered through shared memory; each
    tile's S·⌈O/16⌉ units are split into ``n_split`` runs on as many blocks to
    fill the SMs; each run writes a partial tile to a scratch, and a second
    kernel sums the partials in a fixed order (no atomics: bit-identical from
    call to call). softplus(rho) is computed once per call into an (I, O)
    scratch; O <= 16 takes a narrow path that sums over S in registers.
    A call launches up to three CUDA kernels and counts one launch.
    """
    _check_cotangent(g, loc, rho, n_samples)
    if kernel_precision_default():
        return sampled_dense_dx_bf16(g, loc, rho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_dx, sampled_dense_dx_plain, (g, loc, rho), n_samples, seed,
                                 functools.partial(_dx_buffers, sum_samples=True))


def sampled_dense_xs_fwd(xs, loc, rho, bloc, brho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_fwd_kernel_xs`` (``sampled_dense.py:347``) ->
    ``csrc/sampled_dense_fwd.cu``. (S, B, I) -> (S, B, O).

    Bound on the H100: S·B·I·O exact-f32 FMAs on the FFMA pipe at the hidden
    layer of fc2-1024 (1.34 G) plus its S·I·O normals; the 5.2 MB read of xs
    at the 10-class head. Same design as :func:`sampled_dense_fwd`, xs[s] read
    by the blocks of sample s.
    """
    _check_input(xs, loc, rho, bloc, brho, n_samples)
    if kernel_precision_default():
        return sampled_dense_xs_fwd_bf16(xs, loc, rho, bloc, brho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_xs_fwd, sampled_dense_xs_fwd_plain, (xs, loc, rho, bloc, brho),
                                 n_samples, seed, _fwd_buffers)


def sampled_dense_xs_dx(g, loc, rho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_bwd_xs_dx_kernel`` (``robustbnns_tpu/ops/sampled_dense.py:362``)
    -> ``csrc/sampled_dense_dx.cu``. g (S, B, O) -> dxs (S, B, I) = g_s W_sᵀ.

    Bound on the H100: S·B·I·O exact-f32 FMAs on the FFMA pipe at the hidden
    layer of fc2-1024 (1.34 G) plus its S·I·O normals; the 5.2 MB write of
    dxs at the 10-class head. Design (:func:`dx_plan`): the wide kernel of
    :func:`sampled_dense_dx` with one sample per block; while the grid has
    fewer than three blocks an SM, each sample's chunks of O are split into
    runs whose partial tiles a second kernel sums in a fixed order
    (bit-identical from call to call). O <= 16 takes a narrow path: 128 rows
    x 32 inputs a block, one Philox quad a thread, 128-byte lines of dxs. A
    call launches up to three CUDA kernels and counts one launch.
    """
    _check_cotangent(g, loc, rho, n_samples)
    if kernel_precision_default():
        return sampled_dense_xs_dx_bf16(g, loc, rho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_xs_dx, sampled_dense_xs_dx_plain, (g, loc, rho), n_samples, seed,
                                 functools.partial(_dx_buffers, sum_samples=False))


def sampled_dense_fwd_bf16(x, loc, rho, bloc, brho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_fwd_kernel`` under ``Precision.DEFAULT`` -> the tensor-core
    kernel of ``csrc/sampled_dense_xs_bf16.cu``. (B, I) -> (S, B, O) =
    bf16(x) bf16(W_s) + b_s with f32 sums; reached through
    :func:`sampled_dense_fwd` under ``ROBUSTBNNS_KERNEL_PRECISION=default``.

    Bound on the H100: the S·I·O normals drawn on the FP32 pipe (8.0 M at the
    first layer of fc2-1024, B=128, S=10), far above the products at the 989
    TFLOP/s bf16 peak and the bytes. Design: :func:`sampled_dense_xs_fwd_bf16`'s
    kernel and :func:`xs_bf16_plan` with x's sample stride 0 (every sample's
    blocks read the one x, which stays in L2); no partials. One launch
    counted.
    """
    _check_input(x, loc, rho, bloc, brho, None)
    return _sampled_dense_launch(sampled_dense_fwd_bf16, sampled_dense_fwd_bf16_plain, (x, loc, rho, bloc, brho),
                                 n_samples, seed, functools.partial(_xs_bf16_buffers, kind="fwd"))


def sampled_dense_dx_bf16(g, loc, rho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_bwd_dx_kernel`` under ``Precision.DEFAULT`` -> the tensor-core
    kernel of ``csrc/sampled_dense_dx_bf16.cu``. g (S, B, O) -> dx (B, I) =
    Σ_s bf16(g_s) bf16(W_s)ᵀ with f32 sums; reached through
    :func:`sampled_dense_dx` under ``ROBUSTBNNS_KERNEL_PRECISION=default``.

    Bound on the H100: the S·I·O normals drawn on the FP32 pipe (8.0 M at the
    first layer of fc2-1024, B=128, S=10: 0.0203 ms for a kernel that only
    draws them), far above the products (2.1 µs at the bf16 peak) and the
    bytes (3.6 µs). Design (:func:`dx_bf16_plan`): warp-specialised 128 x 64
    tiles, one block an SM; 16 draw warps copy g by ``cp.async`` two units
    ahead into a ring of four stages and draw W_s into it without waiting on
    the products, each holding its loc and softplus(rho) quads across the S
    samples of a chunk of O (the units run chunk-major); 4 MMA warps run
    ``mma.sync.m16n8k16`` on each stage they are handed (named barriers, no
    ``__syncthreads`` in the loop); each tile's runs sum on chip in pairs, and
    a short pass adds the pairs' partial tiles in a fixed order when there
    are several (bit-identical from call to call). One launch counted.
    """
    _check_cotangent(g, loc, rho, n_samples)
    return _sampled_dense_launch(sampled_dense_dx_bf16, sampled_dense_dx_bf16_plain, (g, loc, rho), n_samples, seed,
                                 _dx_bf16_buffers)


def sampled_dense_xs_fwd_bf16(xs, loc, rho, bloc, brho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_fwd_kernel_xs`` under ``Precision.DEFAULT`` -> the tensor-core
    kernel of ``csrc/sampled_dense_xs_bf16.cu``. (S, B, I) -> (S, B, O) =
    bf16(xs[s]) bf16(W_s) + b_s with f32 sums.

    Bound on the H100: the S·I·O normals drawn on the FP32 pipe (10.5 M at
    the hidden layer of fc2-1024, B=128, S=10: 25.5 µs for a kernel that
    only draws them), far above the products (2.7 µs at the bf16 peak) and
    the bytes (5.6 µs); the 10-class head by moving xs and its launch.
    Design (:func:`xs_bf16_plan`): 128 x 64 tiles of one sample on 8 warps
    of ``mma.sync.m16n8k16``, three blocks an SM; 16-deep chunks of I whose
    xs rows, loc and softplus(rho) ``cp.async`` copies two chunks ahead
    through three stages of shared memory (xs rounded to bf16 as read), one
    barrier a chunk, each thread drawing one quad of the next chunk's W_s
    (stored k-major, read by ``ldmatrix.trans``) while the current chunk's
    products run; each tile's runs one cluster that sums them on chip in a
    fixed order (no partials; bit-identical from call to call). The wide
    path launches a softplus(rho) pass and the kernel, the head (128 x 16
    tiles, 64-deep chunks, softplus inline) one kernel; one launch counted.
    """
    _check_input(xs, loc, rho, bloc, brho, n_samples)
    return _sampled_dense_launch(sampled_dense_xs_fwd_bf16, sampled_dense_xs_fwd_bf16_plain,
                                 (xs, loc, rho, bloc, brho), n_samples, seed,
                                 functools.partial(_xs_bf16_buffers, kind="fwd"))


def sampled_dense_xs_dx_bf16(g, loc, rho, n_samples: int, seed: int) -> torch.Tensor:
    """Pallas ``_bwd_xs_dx_kernel`` under ``Precision.DEFAULT`` -> the
    tensor-core kernel of ``csrc/sampled_dense_xs_bf16.cu``. g (S, B, O) ->
    dxs (S, B, I) = bf16(g_s) bf16(W_s)ᵀ with f32 sums.

    Bound as :func:`sampled_dense_xs_fwd_bf16` (the head by writing dxs).
    Design: its tiles, pipeline and clusters with the columns over I and the
    chunks over O; W_s stored as drawn (its quads run along the contraction),
    each B fragment register one 32-bit read. The head is 128 x 64 tiles of
    one 16-deep chunk of O, softplus inline: one kernel. One launch counted.
    """
    _check_cotangent(g, loc, rho, n_samples)
    return _sampled_dense_launch(sampled_dense_xs_dx_bf16, sampled_dense_xs_dx_bf16_plain, (g, loc, rho), n_samples,
                                 seed, functools.partial(_xs_bf16_buffers, kind="dx"))


def _check_dparams(g, x, rho, brho, n_samples: int, x_lead: tuple) -> None:
    _check_params(rho, rho, brho)
    if g.dim() != 3 or g.shape[0] != n_samples or g.shape[2] != rho.shape[1]:
        raise ValueError(f"g must be (S={n_samples}, B, O={rho.shape[1]}), got {tuple(g.shape)}")
    want = x_lead + (g.shape[1], rho.shape[0])
    if tuple(x.shape) != want:
        raise ValueError(f"the layer input must be {want}, got {tuple(x.shape)}")


def _dparams_buffers(device, n_samples, b_dim, i_dim, o_dim, sms, bf16: bool):
    """The dparams kernels on :func:`dparams_plan`'s geometry (``bf16``:
    :func:`dparams_bf16_plan`'s); the result (dloc, drho, dbloc, dbrho)."""
    plan = (dparams_bf16_plan(n_samples, b_dim, i_dim, o_dim, sms) if bf16
            else dparams_plan(n_samples, i_dim, o_dim, sms))
    grads = (*(torch.empty((i_dim, o_dim), device=device) for _ in range(2)),
             *(torch.empty((o_dim,), device=device) for _ in range(2)))
    return plan.n_split, grads, (_scratch(plan, device), *grads)


def sampled_dense_dparams(g, x, rho, brho, n_samples: int, seed: int):
    """Pallas ``_bwd_dparams_kernel`` (``sampled_dense.py:137``) ->
    ``csrc/sampled_dense_dparams.cu``. g (S, B, O), x (B, I) ->
    ``(dloc, drho, dbloc, dbrho)``, shaped (I, O), (I, O), (O,), (O,).

    Bound on the H100: S·B·I·O exact-f32 FMAs on the FFMA pipe (1.03 G at the
    first layer of fc2-1024, B=128, S=10), plus S·I·O normals drawn in the
    kernel. Design (:func:`dparams_plan`): 128 x 64 tiles of dloc/drho, 8 x 8
    per thread, walk a run of samples, the contraction over the batch in
    16-row chunks double-buffered through shared memory; after each sample
    a thread draws the noise of its own outputs and adds dW_s and dW_s ⊙ eps_s
    into running sums in shared memory, σ(rho) applied once. While the tiles
    fill less than one wave, each tile's samples are split into runs, one
    thread-block cluster, that sum their running sums on chip in a fixed
    order (bit-identical from call to call). O <= 16 takes a narrow path, 32
    inputs a block, whose runs' partial planes a second kernel sums in a
    fixed order. A call launches one or two CUDA kernels and counts one
    launch.
    """
    _check_dparams(g, x, rho, brho, n_samples, ())
    if kernel_precision_default():
        return sampled_dense_dparams_bf16(g, x, rho, brho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_dparams, sampled_dense_dparams_plain, (g, x, rho, brho), n_samples,
                                 seed, functools.partial(_dparams_buffers, bf16=False))


def sampled_dense_xs_dparams(g, xs, rho, brho, n_samples: int, seed: int):
    """Pallas ``_bwd_xs_dparams_kernel`` (``sampled_dense.py:383``) ->
    ``csrc/sampled_dense_dparams.cu``. As :func:`sampled_dense_dparams` with
    the per-sample input xs (S, B, I).

    Bound on the H100: S·B·I·O exact-f32 FMAs at the hidden layer of
    fc2-1024 (1.34 G) plus its S·I·O normals; the 5.2 MB read of xs at the
    10-class head, whose narrow path gives each block 32 inputs and a run of
    samples (320 blocks at B=128, S=10). Same design as
    :func:`sampled_dense_dparams`, xs[s] read for sample s.
    """
    _check_dparams(g, xs, rho, brho, n_samples, (n_samples,))
    if kernel_precision_default():
        return sampled_dense_xs_dparams_bf16(g, xs, rho, brho, n_samples, seed)
    return _sampled_dense_launch(sampled_dense_xs_dparams, sampled_dense_xs_dparams_plain, (g, xs, rho, brho),
                                 n_samples, seed, functools.partial(_dparams_buffers, bf16=False))


def sampled_dense_dparams_bf16(g, x, rho, brho, n_samples: int, seed: int):
    """Pallas ``_bwd_dparams_kernel`` under ``Precision.DEFAULT`` -> the
    tensor-core kernel of ``csrc/sampled_dense_dparams_bf16.cu``. g (S, B, O),
    x (B, I) -> ``(dloc, drho, dbloc, dbrho)`` with dW_s = bf16(x)ᵀ bf16(g_s),
    f32 sums; reached through :func:`sampled_dense_dparams` under
    ``ROBUSTBNNS_KERNEL_PRECISION=default``.

    Bound on the H100: moving the operands once (15.3 MB at the first layer
    of fc2-1024, B=128, S=10: 4.6 µs) is above 2·S·B·I·O FLOP at the 989
    TFLOP/s bf16 peak (2.1 µs); the S·I·O normals drawn on the FP32 pipe set
    the floor. Design (:func:`dparams_bf16_plan`): 128 x 64 tiles of
    dloc/drho on 8 warps, two blocks an SM; 32-row chunks of x and g copied
    as they lie by ``cp.async`` two chunks ahead through three stages
    (rounded to bf16 as read), the batch contraction on
    ``mma.sync.m16n8k16``, the fragments ordered so that a lane's
    accumulators hold whole Philox quads; each lane draws its own quads of
    eps_s, a share with each chunk, before the chunk's products; dW_s, and
    the running sums of dW_s and dW_s ⊙ eps_s, in registers; each tile's
    runs one cluster that
    sums them on chip in a fixed order. The bias as the f32 kernel's, on the
    unrounded g. O <= 16 takes the head: 64 threads and 32 inputs a block,
    64-row chunks of x_s and g_s copied as they lie by ``cp.async`` two
    chunks ahead, the same fragment order, the runs of samples grouped into
    the ranks of one cluster an input block that sums them on chip (the bias
    subtotals of the runs added in run order); one kernel. One launch
    counted.
    """
    _check_dparams(g, x, rho, brho, n_samples, ())
    return _sampled_dense_launch(sampled_dense_dparams_bf16, sampled_dense_dparams_bf16_plain, (g, x, rho, brho),
                                 n_samples, seed, functools.partial(_dparams_buffers, bf16=True))


def sampled_dense_xs_dparams_bf16(g, xs, rho, brho, n_samples: int, seed: int):
    """Pallas ``_bwd_xs_dparams_kernel`` under ``Precision.DEFAULT``: as
    :func:`sampled_dense_dparams_bf16` with the per-sample input xs (S, B, I)."""
    _check_dparams(g, xs, rho, brho, n_samples, (n_samples,))
    return _sampled_dense_launch(sampled_dense_xs_dparams_bf16, sampled_dense_xs_dparams_bf16_plain,
                                 (g, xs, rho, brho), n_samples, seed, functools.partial(_dparams_buffers, bf16=True))


KERNEL_WRAPPERS = (
    sampled_dense_fwd, sampled_dense_dx, sampled_dense_dparams,
    sampled_dense_xs_fwd, sampled_dense_xs_dx, sampled_dense_xs_dparams,
    sampled_dense_fwd_bf16, sampled_dense_dx_bf16, sampled_dense_xs_fwd_bf16, sampled_dense_xs_dx_bf16,
    sampled_dense_dparams_bf16, sampled_dense_xs_dparams_bf16,
)


build.LAUNCH_COUNTERS.update({wrapper.__name__: "sampled_dense." + wrapper.__name__ for wrapper in KERNEL_WRAPPERS})


def reset_launch_counts() -> None:
    reset_counters("sampled_dense.")


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches, by its name: :func:`.build.launch_counts`' sampled-dense part."""
    return {name: n for name, n in build.launch_counts().items() if name in SIGNATURES}


# --------------------------------------------------------------------------- #
# Autograd glue (replaces the JAX custom VJPs, sampled_dense.py:320 and :525)
# --------------------------------------------------------------------------- #


def _backward(ctx, g, dx_kernel, dparams_kernel):
    """The input and the parameter cotangents, each launched only if asked for."""
    x, loc, rho, brho = ctx.saved_tensors
    g = g.contiguous()
    need_x, need_params = ctx.needs_input_grad[0], ctx.needs_input_grad[1:5]
    dx = dx_kernel(g, loc, rho, ctx.n_samples, ctx.seed) if need_x else None
    dparams = (None,) * 4
    if any(need_params):
        dparams = tuple(
            d if need else None
            for d, need in zip(dparams_kernel(g, x, rho, brho, ctx.n_samples, ctx.seed), need_params)
        )
    return (dx, *dparams, None, None)


class SampledDense(torch.autograd.Function):
    """``sampled_dense`` with a backward that regenerates the noise.

    Saves (x, loc, rho, brho, seed), never the sampled weights.
    """

    @staticmethod
    def forward(ctx, x, loc, rho, bloc, brho, n_samples: int, seed: int):
        x, loc, rho, bloc, brho = (t.contiguous() for t in (x, loc, rho, bloc, brho))
        ctx.save_for_backward(x, loc, rho, brho)
        ctx.n_samples, ctx.seed = n_samples, seed
        return sampled_dense_fwd(x, loc, rho, bloc, brho, n_samples, seed)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, sampled_dense_dx, sampled_dense_dparams)


class SampledDenseXs(torch.autograd.Function):
    """``sampled_dense_xs`` with a backward that regenerates the noise."""

    @staticmethod
    def forward(ctx, xs, loc, rho, bloc, brho, n_samples: int, seed: int):
        xs, loc, rho, bloc, brho = (t.contiguous() for t in (xs, loc, rho, bloc, brho))
        ctx.save_for_backward(xs, loc, rho, brho)
        ctx.n_samples, ctx.seed = n_samples, seed
        return sampled_dense_xs_fwd(xs, loc, rho, bloc, brho, n_samples, seed)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, sampled_dense_xs_dx, sampled_dense_xs_dparams)


def sampled_dense(x, loc, rho, bloc, brho, n_samples: int, seed: int = 0) -> torch.Tensor:
    """``(S, B, O)`` outputs of S sampled dense layers. ``x``: (B, I);
    ``loc``/``rho``: (I, O); ``bloc``/``brho``: (O,); ``seed``: a Python int."""
    return SampledDense.apply(x, loc, rho, bloc, brho, n_samples, int(seed))


def sampled_dense_xs(xs, loc, rho, bloc, brho, n_samples: int, seed: int = 0) -> torch.Tensor:
    """Per-sample-input sampled dense: ``y[s] = xs[s] @ W_s + b_s``; ``xs``: (S, B, I)."""
    return SampledDenseXs.apply(xs, loc, rho, bloc, brho, n_samples, int(seed))


def sampled_dense_reference(x, loc, rho, bloc, brho, n_samples: int, generator, *, eps_w=None, eps_b=None):
    """Plain reference of the same op with independent normal draws (port of
    ``sampled_dense_reference``, ``sampled_dense.py:323-338``), ``(S, B, O)``:
    ``out[s] = x @ (loc + softplus(rho)·eps_w[s]) + bloc + softplus(brho)·eps_b[s]``.

    ``eps_w`` (S, I, O) and ``eps_b`` (S, O) default to ``torch.randn`` draws
    from ``generator`` (:func:`.utils.prng.key_from_seed`), moved to ``x``'s
    device; a test passes JAX's draws in their place. They are not the
    kernels' Philox stream, so the kernels meet it in distribution (moments)
    and exactly in the zero-scale limit, where the noise cancels. No path of
    the port calls it.
    """
    shapes = ((n_samples, *loc.shape), (n_samples, *bloc.shape))
    eps = []
    for given, shape in zip((eps_w, eps_b), shapes):
        if given is None:
            given = torch.randn(shape, generator=generator, device=generator.device, dtype=loc.dtype)
        elif tuple(given.shape) != shape:
            raise ValueError(f"noise of shape {tuple(given.shape)}, expected {shape}")
        eps.append(given.to(x.device))
    w = loc + softplus(rho) * eps[0]
    b = bloc + softplus(brho) * eps[1]
    return torch.matmul(x, w) + b[:, None, :]
