"""Shapes and FLOP of ``fc2``: 784 -> hidden -> hidden -> classes for MNIST."""
from __future__ import annotations


def param_shapes(config: dict) -> list:
    """Each layer's ``w`` (I, O) and ``b`` (O,), and its fan-in I."""
    h, w, c = config["input_shape"]
    dims = [h * w * c, config["hidden_size"], config["hidden_size"], config["output_size"]]
    return [{"w": (i, o), "b": (o,), "fan_in": i} for i, o in zip(dims[:-1], dims[1:])]


def forward_flops(config: dict) -> list:
    return [2.0 * layer["w"][0] * layer["w"][1] for layer in param_shapes(config)]
