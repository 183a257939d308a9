"""Plain reference of the Bayesian CCT-7/3×1 (Hassani et al. 2021, *Escaping
the Big Data Paradigm with Compact Transformers*, arXiv:2104.05704; the
paper's code ``SHI-Labs/Compact-Transformers``: ``Tokenizer``,
``TransformerEncoderLayer``, ``TransformerClassifier``), one draw at a time,
in plain ``torch`` and in the dtype asked for (float64 or float32). It
imports nothing of the port.

Layer equations, with d the embedding width (256 as published), 4 heads of
d/4, NHWC inputs and ``act`` the tokenizer's activation (ReLU):

* tokenizer: ``t = maxpool3x3/2,pad1(act(conv3x3(x; C -> d, stride 1, pad
  1, no bias)))``, the pixels in row-major (h, w) order as T tokens (256 on
  32×32 inputs); ``z = t + P``, P ``(T, d)`` a learnt positional table;
* each of 7 layers: ``a = MHSA(LN_pre(z))``, with ``q, k, v =
  LN_pre(z)·[W_q|W_k|W_v]`` (no bias), per head ``softmax(q·kᵀ/sqrt(d/4))·v``,
  the heads side by side, then ``·W_o + b_o``; ``z = LN_1(z + a)`` (CCT
  normalises the residual stream itself here); ``z = z + gelu(z·W_1 +
  b_1)·W_2 + b_2`` (d -> 2d -> d, GELU in its erf form);
* head: ``z = LN_f(z)``; sequence pooling ``p = softmax_T(z·w_g + b_g)``,
  ``v = Σ_t p_t z_t``; ``logits = v·W + b`` (10 classes).

Every LayerNorm normalises over d with eps 1e-5, then scales by γ and shifts
by β. Parameters: 39 layers of ``{"w", "b"}``: the tokenizer's conv ``w``
HWIO ``(3, 3, C, d)`` with P in ``"b"`` (the conv has no bias); per encoder
layer LN_pre ``{γ, β}``, attention ``{[W_q|W_k|W_v|W_o] (d, 4d), b_o}``,
LN_1, ``{W_1, b_1}``, ``{W_2, b_2}``; then LN_f, the pooling's ``{w_g (d,
1), b_g (1,)}`` and the head. Dropout, attention dropout and stochastic
depth are train-time only and absent.

On a card, a float32 product may run in TF32: importing this module turns
that off for matmuls and cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAYERS, HEADS = 7, 4
ACTIVATIONS = {
    "relu": F.relu,
    "leaky": lambda t: F.leaky_relu(t, negative_slope=0.01),
    "sigm": torch.sigmoid,
    "tanh": torch.tanh,
}


def layer_norm(z: torch.Tensor, layer: dict, dtype=torch.float64) -> torch.Tensor:
    """``(z - mean) / sqrt(var + 1e-5)·γ + β`` over the last axis (the biased variance)."""
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    return (z - mean) / torch.sqrt(var + 1e-5) * layer["w"].to(dtype) + layer["b"].to(dtype)


def self_attention(z: torch.Tensor, layer: dict, dtype=torch.float64) -> torch.Tensor:
    """Multi-head self-attention of ``z`` ``(batch, T, d)`` with the weights
    ``[W_q|W_k|W_v|W_o]`` and ``b_o``, head by head."""
    width = z.shape[-1]
    head = width // HEADS
    w = layer["w"].to(dtype)
    q, k, v = (z @ w[:, i * width:(i + 1) * width] for i in range(3))
    heads = []
    for h in range(HEADS):
        cols = slice(h * head, (h + 1) * head)
        scores = q[..., cols] @ k[..., cols].transpose(-1, -2) / head ** 0.5
        heads.append(torch.softmax(scores, -1) @ v[..., cols])
    return torch.cat(heads, -1) @ w[:, 3 * width:] + layer["b"].to(dtype)


def logits(layers: list, x: torch.Tensor, activation: str = "relu", dtype=torch.float64) -> torch.Tensor:
    """One draw's ``(batch, classes)`` logits of NHWC ``x``."""
    x = x.to(dtype).permute(0, 3, 1, 2)
    t = F.conv2d(x, layers[0]["w"].to(dtype).permute(3, 2, 0, 1), None, stride=1, padding=1)
    t = F.max_pool2d(ACTIVATIONS[activation](t), 3, 2, 1)
    z = t.flatten(2).transpose(1, 2) + layers[0]["b"].to(dtype)  # (batch, T, d), row-major pixels
    for i in range(LAYERS):
        ln_pre, attn, ln_1, mlp_1, mlp_2 = layers[1 + 5 * i:6 + 5 * i]
        z = layer_norm(z + self_attention(layer_norm(z, ln_pre, dtype), attn, dtype), ln_1, dtype)
        hidden = F.gelu(z @ mlp_1["w"].to(dtype) + mlp_1["b"].to(dtype))
        z = z + hidden @ mlp_2["w"].to(dtype) + mlp_2["b"].to(dtype)
    z = layer_norm(z, layers[-3], dtype)
    pool = torch.softmax(z @ layers[-2]["w"].to(dtype) + layers[-2]["b"].to(dtype), dim=1)  # (batch, T, 1)
    v = (pool * z).sum(1)
    return v @ layers[-1]["w"].to(dtype) + layers[-1]["b"].to(dtype)


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
