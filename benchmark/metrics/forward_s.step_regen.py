"""forward_s.step_regen: the reading of ``forward_s.step``, in the
step cell that reports no end-to-end step rate."""
from harness import cells


def read(record):
    return cells.reader("forward_s.step").read(record)
