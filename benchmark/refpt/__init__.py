"""refpt: the benchmark's plain reference path tracer.

A frozen copy of the plain PyTorch path of ``fountain_tpu_torch`` (commit
6354002), with every CUDA and native branch taken out: the sweeps and the
BVH walk are their plain PyTorch versions and the LBVH build is numpy's,
on the CPU and on a card alike. It imports nothing of the package under
test; the benchmark loads its scenes with ``refpt.io.pbrt.load_pbrt`` from
its own frozen files and compares the program's outputs with these.
"""
