"""Plain reference of the Bayesian ResNet-20 (He et al. 2016, arXiv:1512.03385,
sec. 4.2), one draw at a time, in plain ``torch`` and in the dtype asked for
(float64 or float32). It imports nothing of the port.

Layer equations, with ``w`` the base width (16 as published), NHWC inputs and
``act`` the activation:

* ``h = act(conv3x3(x; C -> w, stride 1, pad 1) + b)``;
* three stages of widths w, 2w, 4w, three basic blocks each:
  ``y = act(conv3x3(h; stride s, pad 1) + b1)``, then
  ``h = act(conv3x3(y; stride 1, pad 1) + b2 + shortcut(h))``, with s = 2 in
  the first block of stages 2 and 3 and 1 elsewhere;
* ``shortcut`` the identity or, where the width doubles, option A:
  ``h[:, ::2, ::2, :]`` with zeros a quarter of the new width on each side of
  the old channels (8 + 16 + 8 for 16 -> 32);
* global average pooling, then ``logits = h @ W + b`` (4w -> classes).

Parameters: 20 layers of ``{"w", "b"}``, conv ``w`` HWIO ``(3, 3, C_in,
C_out)``, head ``w`` ``(4w, classes)``. BatchNorm is taken in its inference
form, folded into each conv's weight and bias; no per-pixel mean is
subtracted.

On a card, a float32 product may run in TF32: importing this module turns
that off for matmuls and cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ACTIVATIONS = {
    "relu": F.relu,
    "leaky": lambda t: F.leaky_relu(t, negative_slope=0.01),
    "sigm": torch.sigmoid,
    "tanh": torch.tanh,
}


def option_a(h: torch.Tensor, out_channels: int) -> torch.Tensor:
    """The option-A shortcut of NCHW ``h``: every other pixel, zeros on both sides of the channels."""
    h = h[:, :, ::2, ::2]
    pad = (out_channels - h.shape[1]) // 2
    return torch.cat([h.new_zeros((h.shape[0], pad) + h.shape[2:]), h,
                      h.new_zeros((h.shape[0], pad) + h.shape[2:])], dim=1)


def logits(layers: list, x: torch.Tensor, activation: str = "relu", dtype=torch.float64) -> torch.Tensor:
    """One draw's ``(batch, classes)`` logits of NHWC ``x``."""
    act = ACTIVATIONS[activation]

    def conv(h, layer, stride):
        return F.conv2d(h, layer["w"].to(dtype).permute(3, 2, 0, 1), layer["b"].to(dtype), stride=stride, padding=1)

    h = act(conv(x.to(dtype).permute(0, 3, 1, 2), layers[0], 1))
    i = 1
    for stage in range(3):
        for block in range(3):
            stride = 2 if stage > 0 and block == 0 else 1
            y = act(conv(h, layers[i], stride))
            y = conv(y, layers[i + 1], 1)
            h = act(y + (h if stride == 1 else option_a(h, y.shape[1])))
            i += 2
    h = h.mean(dim=(2, 3))
    return h @ layers[-1]["w"].to(dtype) + layers[-1]["b"].to(dtype)


def draw(stacked: list, s: int) -> list:
    """Draw ``s`` of stacked layers (a leading draw axis on every leaf)."""
    return [{k: v[s] for k, v in layer.items()} for layer in stacked]


def stacked_logits(stacked: list, x: torch.Tensor, activation: str = "relu", dtype=torch.float64) -> torch.Tensor:
    """``(S, batch, classes)``, the draws looped over; ``x`` shared ``(batch, h, w, c)``
    or one batch a draw ``(S, batch, h, w, c)``."""
    n = stacked[0]["w"].shape[0]
    return torch.stack([logits(draw(stacked, s), x[s] if x.dim() == 5 else x, activation, dtype) for s in range(n)])


def predictive_and_input_gradient(stacked: list, x: torch.Tensor, labels: torch.Tensor, activation: str = "relu",
                                  dtype=torch.float64):
    """The S-draw predictive (mean softmax) and the input gradient of the
    attack's loss, the cross-entropy summed over the batch on those
    probabilities."""
    xr = x.detach().to(dtype).requires_grad_(True)
    probs = torch.softmax(stacked_logits(stacked, xr, activation, dtype), -1).mean(0)
    loss = -F.log_softmax(probs, -1).gather(-1, labels[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xr)
    return probs.detach(), grad


def neg_elbo_and_gradients(loc: list, rho: list, eps: list, x: torch.Tensor, labels: torch.Tensor,
                           activation: str = "relu", dtype=torch.float64):
    """The negative ELBO of one draw ``loc + softplus(rho)·eps`` on the batch,
    ``KL(q || N(0, 1)) - sum_i log softmax(f_w(x_i))[y_i]``, and its gradient
    in every leaf: ``(loss, loc_grads, rho_grads)``, each gradient list in
    layer order with ``{"w", "b"}`` dicts."""
    m = [{k: v.detach().to(dtype).requires_grad_(True) for k, v in layer.items()} for layer in loc]
    r = [{k: v.detach().to(dtype).requires_grad_(True) for k, v in layer.items()} for layer in rho]
    w = [{k: m[i][k] + F.softplus(r[i][k]) * eps[i][k].to(dtype) for k in m[i]} for i in range(len(m))]
    ll = F.log_softmax(logits(w, x, activation, dtype), -1).gather(-1, labels[:, None]).sum()
    kl = sum(torch.sum(0.5 * (s * s + mu * mu - 1.0) - torch.log(s))
             for mu, s in ((m[i][k], F.softplus(r[i][k])) for i in range(len(m)) for k in m[i]))
    loss = kl - ll
    loss.backward()
    grads = [[{k: layer[k].grad for k in layer} for layer in tree] for tree in (m, r)]
    return loss.detach(), grads[0], grads[1]
