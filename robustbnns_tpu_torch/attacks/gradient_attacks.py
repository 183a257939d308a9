"""FGSM and PGD on Bayesian predictives (port of
``robustbnns_tpu/attacks/gradient_attacks.py``, the slice's part).

Reference semantics (``adversarialAttacks.py:69-198``):

* **FGSM**: ``x' = clamp(x + ε·sign(∇ₓ CE(f(x), y)), 0, 1)``, ε = 0.3;
* **PGD**: 40 full sign steps of ``alpha = 2 / image.max()`` (or
  ``(ε, α) = (0.5, 2/225)`` without hyperparameters), each projected onto the
  ε-ball around the clean image and clamped to [0, 1]; no random start;
* **CE-on-outputs quirk**: the loss is ``CrossEntropyLoss`` applied to whatever
  the model emits — averaged *probabilities* for a BNN;
* **Bayesian re-sampling**: every forward draws fresh weights, so every PGD
  iteration sees new ones (an HMC posterior's predictive is its fixed draws);
* **denormal gradients count as zero** before the sign, as XLA's flush to
  zero makes them in the JAX package.

Batches are attacked whole: per-image CE losses are summed and differentiated
in one backward pass. The draws of an iteration are shared across the images
of a batch, as in the JAX package; every per-image marginal is unchanged.
``forward_fn`` is a closure ``f(x, generator)`` from ``model.predictive_fn``;
one CPU ``torch.Generator`` threads through all batches and iterations.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.attacks.measures import softmax_robustness
from robustbnns_tpu_torch.config import TESTS


def ce_on_outputs(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``CrossEntropyLoss`` on the raw model output: ``-log_softmax(out)[y]``."""
    return -F.log_softmax(outputs, dim=-1).gather(-1, labels[:, None])[:, 0]


def _labels(y: torch.Tensor) -> torch.Tensor:
    return y if y.dim() == 1 else y.argmax(dim=-1)


def _input_gradients(forward_fn, x, labels, generator):
    """Per-image ∇ₓ CE — one batched forward/backward (summed CE)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = ce_on_outputs(forward_fn(x, generator), labels).sum()
        (grad,) = torch.autograd.grad(loss, x)
    return grad


def _gradient_sign(grads: torch.Tensor) -> torch.Tensor:
    """``sign(grads)`` with denormal entries counted as zero, as XLA's flush
    to zero gives the JAX package on the CPU and the TPU: a saturated softmax
    can leave a gradient near 1e-42 where JAX's is exactly 0, and its sign
    would move a pixel that JAX's attack leaves."""
    tiny = torch.finfo(grads.dtype).tiny
    return torch.sign(torch.where(grads.abs() < tiny, 0.0, grads))


def fgsm_attack(
    forward_fn: Callable,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    epsilon: float = 0.3,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batched FGSM (reference ``adversarialAttacks.py:69-83``). ``y`` may be
    one-hot or integer labels; ``generator`` seeds the posterior draws."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    grads = _input_gradients(forward_fn, x, _labels(y), generator)
    return torch.clamp(x + epsilon * _gradient_sign(grads), 0.0, 1.0)


def pgd_attack(
    forward_fn: Callable,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    epsilon: Optional[float] = 0.3,
    alpha: Optional[float] = None,
    iters: int = 40,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batched 40-iteration PGD (reference ``adversarialAttacks.py:86-108``).

    With ``epsilon`` given and ``alpha=None`` the step is the reference's
    per-image ``alpha = 2 / image.max()``; ``epsilon=None`` selects
    ``(0.5, 2/225)``.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    labels = _labels(y)
    if epsilon is None:
        epsilon, alpha = 0.5, 2.0 / 225.0
    if alpha is None:
        per_image_max = x.reshape(x.shape[0], -1).amax(dim=-1)
        alpha = (2.0 / per_image_max).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    x0 = x
    for _ in range(iters):
        grads = _input_gradients(forward_fn, x, labels, generator)
        eta = torch.clamp(x + alpha * _gradient_sign(grads) - x0, -epsilon, epsilon)
        x = torch.clamp(x0 + eta, 0.0, 1.0)
    return x


def attack(
    model,
    x_test,
    y_test,
    *,
    method: str,
    epsilon: float = 0.3,
    n_samples: Optional[int] = None,
    avg_posterior: bool = False,
    fused: bool = False,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 128,
    filename: Optional[str] = None,
    savedir: Optional[str] = None,
    rel_path: str = TESTS,
    save: bool = True,
    verbose: bool = True,
) -> torch.Tensor:
    """Attack a whole test set batch by batch (reference ``attack()``, ``:111-143``).

    ``model`` has ``predictive_fn(n_samples, avg_posterior=..., fused=...)`` and a
    ``device``. ``fused=True`` selects the CUDA sampled-dense predictive. The
    adversarial set is saved as npz under the JAX package's file name. The
    original and adversarial image grids that the JAX package draws beside it
    (``gradient_attacks.py:288-294``) are not drawn: the card's machine has no
    matplotlib. :func:`.utils.plotting.plot_save_grid_images` draws them from
    the saved set where matplotlib is installed.
    """
    if verbose:
        print(f"\nProducing {method} attacks:")
    if method not in ("fgsm", "pgd"):
        raise ValueError(f"unknown attack method {method!r}")
    x = torch.as_tensor(x_test, device=model.device)
    y = torch.as_tensor(y_test, device=model.device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    kwargs = {"fused": True} if fused else {}
    forward_fn = model.predictive_fn(n_samples=n_samples, avg_posterior=avg_posterior, **kwargs)
    run = fgsm_attack if method == "fgsm" else pgd_attack
    x_adv = torch.cat([
        run(forward_fn, x[i : i + batch_size], y[i : i + batch_size],
            epsilon=epsilon, generator=generator)
        for i in range(0, x.shape[0], batch_size)
    ])
    if save and filename is not None:
        save_attack(
            x_adv, method=method, filename=filename, savedir=savedir,
            n_samples=n_samples, rel_path=rel_path,
        )
    return x_adv


def _attack_path(method, filename, savedir, n_samples, rel_path) -> str:
    """Reference naming scheme (``adversarialAttacks.py:135-141,145-149``)."""
    d = os.path.join(rel_path, savedir if savedir is not None else filename)
    name = f"{filename}_{method}"
    name += f"_attackSamp={n_samples}_attack" if n_samples else "_attack"
    return os.path.join(d, name + ".npz")


def save_attack(x_adv, *, method, filename, savedir=None, n_samples=None, rel_path=TESTS):
    path = _attack_path(method, filename, savedir, n_samples, rel_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, x_adv=torch.as_tensor(x_adv).detach().cpu().numpy())
    return path


def load_attack(*, method, filename, savedir=None, n_samples=None, rel_path=TESTS, device="cpu"):
    path = _attack_path(method, filename, savedir, n_samples, rel_path)
    with np.load(path) as data:
        return torch.as_tensor(data["x_adv"], device=device)


def attack_evaluation(
    model,
    x_test,
    x_attack,
    y_test,
    *,
    n_samples: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 128,
    verbose: bool = True,
):
    """Clean vs adversarial accuracy + softmax robustness (reference ``:151-198``).

    The evaluation draws are seeded: ``generator`` defaults to seed 0, as the
    reference sets ``pyro.set_rng_seed(0)`` (``:160-161``), and the clean and
    adversarial passes each get a generator of their own, drawn from it.
    """
    from robustbnns_tpu_torch.predict import batched_eval
    from robustbnns_tpu_torch.utils.prng import draw_seed, key_from_seed

    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    g1, g2 = (key_from_seed(draw_seed(generator)) for _ in range(2))
    forward_fn = model.predictive_fn(n_samples=n_samples)
    x = torch.as_tensor(x_test, device=model.device)
    xa = torch.as_tensor(x_attack, device=model.device)
    y = torch.as_tensor(y_test, device=model.device)
    original_outputs, orig_correct = batched_eval(forward_fn, x, y, batch_size=batch_size, generator=g1)
    adversarial_outputs, adv_correct = batched_eval(forward_fn, xa, y, batch_size=batch_size, generator=g2)
    original_accuracy = 100.0 * float(orig_correct) / x.shape[0]
    adversarial_accuracy = 100.0 * float(adv_correct) / x.shape[0]
    if verbose:
        print(
            f"\ntest accuracy = {original_accuracy}\tadversarial accuracy = {adversarial_accuracy}",
            end="\t",
        )
    softmax_rob = softmax_robustness(original_outputs, adversarial_outputs, verbose=verbose)
    return original_accuracy, adversarial_accuracy, softmax_rob
