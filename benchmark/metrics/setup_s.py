"""setup_s: process start to the window's start (imports, CUDA context,
the scene load, the kernel libraries from their caches, one warm unit),
host clock."""


def read(record):
    return record["setup_s"]
