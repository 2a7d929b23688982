# Frozen copy of fountain_tpu_torch/core/__init__.py (commit 6354002): the benchmark's plain reference; edit never.
