"""backward_s.step_regen: the reading of ``backward_s.step``, in the
step cell that reports no end-to-end step rate."""
from harness import cells


def read(record):
    return cells.reader("backward_s.step").read(record)
