# Frozen copy of fountain_tpu_torch/lights/__init__.py (commit 6354002): the benchmark's plain reference; edit never.
