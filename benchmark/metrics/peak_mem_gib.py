"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(record):
    return record["peak_bytes"] / 2 ** 30 if record["peak_bytes"] else None
