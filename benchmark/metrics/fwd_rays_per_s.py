"""fwd_rays_per_s: the rays of all the window's forward waves over the
window's wall time; ``render_regen`` cells."""


def read(record):
    if record["kind"] != "render_regen":
        return None
    return record["rays"] / record["window_s"]
