"""Shapes and FLOP of ``resnet20``: a 3×3 conv (C -> w), three stages of
three basic blocks of two 3×3 convs (widths w, 2w, 4w; stride 2 in the first
conv of stages 2 and 3; padding 1), global average pooling, dense (4w ->
classes); conv weights HWIO. The shortcuts, residual adds and pooling carry
no products."""
from __future__ import annotations


def _convs(config: dict) -> list:
    """Each conv's ``(c_in, c_out, output side h, output side w)``."""
    h, w, c = config["input_shape"]
    width = config["hidden_size"]
    convs = [(c, width, h, w)]
    c = width
    for stage in range(3):
        out = width << stage
        for block in range(3):
            if stage and not block:
                h, w = h // 2, w // 2
            convs += [(c, out, h, w), (out, out, h, w)]
            c = out
    return convs


def param_shapes(config: dict) -> list:
    convs = _convs(config)
    width, out = convs[-1][1], config["output_size"]
    return [{"w": (3, 3, c_in, c_out), "b": (c_out,), "fan_in": 9 * c_in} for c_in, c_out, _, _ in convs] + [
        {"w": (width, out), "b": (out,), "fan_in": width}]


def forward_flops(config: dict) -> list:
    convs = _convs(config)
    return [2.0 * h * w * c_out * 9 * c_in for c_in, c_out, h, w in convs] + [
        2.0 * convs[-1][1] * config["output_size"]]
