"""The residual trunk's convolutions that ``F.conv2d`` (cuDNN) ran rather
than a hand-written kernel, a PGD iteration:
the program's ``resnet.cudnn_convs`` counter over its ``attack.iterations``
in the spans stretch (:mod:`benchmark.spans`). Nothing to read where no
``resnet.forwards`` counted, as in a program without ``resnet20``."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    counters = spans.of(ctx)["counters"]
    if not counters.get("resnet.forwards"):
        return None
    return counters.get("resnet.cudnn_convs", 0) / spans.units(ctx)
