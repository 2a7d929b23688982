"""device_idle_pct.render: 100 x (1 - the device-busy time of one
profiled wave / the host-clock time of the same wave run unprofiled).
The profiler slows the host, so its own wall time is not used."""


def read(record):
    if record["kind"] != "render_regen":
        return None
    busy = record.get("profile", {}).get("busy_s")
    wall = record.get("spans", {}).get("unit")
    return None if not busy or not wall else 100.0 * (1.0 - busy / wall)
