"""device_idle_pct.step_regen: the reading of ``device_idle_pct.step``, in the
step cell that reports no end-to-end step rate."""
from harness import cells


def read(record):
    return cells.reader("device_idle_pct.step").read(record)
