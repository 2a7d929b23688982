# Frozen copy of fountain_tpu_torch/io/__init__.py (commit 6354002): the benchmark's plain reference; edit never.
