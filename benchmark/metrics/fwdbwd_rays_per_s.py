"""fwdbwd_rays_per_s: the rays of all the window's steps (forward and
backward) over the window's wall time; ``step`` cells."""


def read(record):
    if record["kind"] != "step":
        return None
    return record["rays"] / record["window_s"]
