"""Shapes and FLOP of ``conv``: conv5 (C -> 32, valid), pool 2/2, conv5
(32 -> hidden, valid), pool 2/1, dense (7 * 7 * hidden -> classes) for 28 x 28
inputs; conv weights HWIO."""
from __future__ import annotations


def _sides(config: dict):
    h, w, c = config["input_shape"]
    h1, w1 = h - 4, w - 4  # after conv1
    h2, w2 = h1 // 2 - 4, w1 // 2 - 4  # after pool 2/2 and conv2
    return c, (h1, w1), (h2, w2), (h2 - 1, w2 - 1)  # the last: after pool 2/1


def param_shapes(config: dict) -> list:
    c, _, _, (h3, w3) = _sides(config)
    hidden, out = config["hidden_size"], config["output_size"]
    return [
        {"w": (5, 5, c, 32), "b": (32,), "fan_in": 25 * c},
        {"w": (5, 5, 32, hidden), "b": (hidden,), "fan_in": 25 * 32},
        {"w": (h3 * w3 * hidden, out), "b": (out,), "fan_in": h3 * w3 * hidden},
    ]


def forward_flops(config: dict) -> list:
    c, (h1, w1), (h2, w2), (h3, w3) = _sides(config)
    hidden, out = config["hidden_size"], config["output_size"]
    return [2.0 * h1 * w1 * 32 * 25 * c, 2.0 * h2 * w2 * hidden * 25 * 32, 2.0 * h3 * w3 * hidden * out]
