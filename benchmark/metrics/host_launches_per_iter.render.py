"""host_launches_per_iter.render: CUDA runtime calls that put work on the
device (kernel launches, copies, fills, graph launches) made by the host
in one profiled wave, over the wave's iterations. Host calls, not device
kernels: a CUDA graph shows as fewer."""


def read(record):
    if record["kind"] != "render_regen":
        return None
    n = record.get("profile", {}).get("launch_calls", {}).get("unit")
    return None if not n else n / record["iterations"]
