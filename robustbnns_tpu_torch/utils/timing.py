"""Wall-clock reporting (port of ``robustbnns_tpu/utils/timing.py``, the slice's part)."""
from __future__ import annotations


def execution_time(start: float, end: float) -> str:
    """Format + print elapsed wall-clock time (reference ``utils.py:15-18``)."""
    hours, rem = divmod(end - start, 3600)
    minutes, seconds = divmod(rem, 60)
    msg = "\nExecution time = {:0>2}:{:0>2}:{:0>2}".format(int(hours), int(minutes), int(seconds))
    print(msg)
    return msg
