"""fwdbwd_rays_per_s.step_regen: ``fwdbwd_rays_per_s`` read per layer in
the cell whose host-clock rate spreads too widely to hold to an
end-to-end bound: the rays of all the window's steps over the window's
wall time."""
from harness import cells


def read(record):
    return cells.reader("fwdbwd_rays_per_s").read(record)
