"""device_idle_pct.step: 100 x (1 - the device-busy time of one profiled
step / the host-clock time of the same step run unprofiled)."""


def read(record):
    if record["kind"] != "step":
        return None
    busy = record.get("profile", {}).get("busy_s")
    wall = record.get("spans", {}).get("unit")
    return None if not busy or not wall else 100.0 * (1.0 - busy / wall)
