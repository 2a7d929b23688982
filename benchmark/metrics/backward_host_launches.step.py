"""backward_host_launches.step: CUDA runtime calls that put work on the
device (kernel launches, copies, fills, graph launches) made by the host
during one step's backward pass, from the profiler's trace."""


def read(record):
    if record["kind"] != "step":
        return None
    calls = record.get("profile", {}).get("launch_calls", {})
    return calls.get("backward")
