"""backward_host_launches.step_regen: the reading of
``backward_host_launches.step``, in the step cell that reports no
end-to-end step rate."""
from harness import cells


def read(record):
    return cells.reader("backward_host_launches.step").read(record)
