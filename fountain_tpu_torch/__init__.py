"""fountain_tpu_torch: the PyTorch/CUDA port of fountain_tpu.

The package mirrors ``fountain_tpu``'s subpackages and module names. Plain
tensor code is PyTorch; the two triangle sweeps that ``fountain_tpu`` wrote
as Pallas TPU kernels are hand-written CUDA kernels for Hopper (sm_90a) in
``csrc/tri_sweep.cu``, bound through ctypes (``geometry/tri_sweep.py``), and
so is its BVH walk, which it runs off the TPU for meshes above 65,536 faces
(``csrc/bvh_walk.cu``, ``geometry/bvh_walk.py``). The LBVH build is C++
(``csrc/lbvh.cc``, ``native.py``).

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
Kernel wrappers dispatch on the tensor's device: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
