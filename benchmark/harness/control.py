"""The control of the check: the reference put in the program's place and
computed in bfloat16, the next precision below the float32 that both
configurations state. Every float table of the scene and the camera is
rounded to bfloat16 (the walk's node rows, which hold integer bit
patterns, excepted), and so is the lane state (origins, directions,
throughput, radiance, cone width, previous pdf) on entry to and exit
from every bounce: the step a later change would take to store them in
half the bytes. A check whose limits this control passes cannot tell a
sound program from one computing in a lower precision."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from harness import cells

_KEEP = ("bvh_nodes8",)     # integer bit patterns in float rows


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def round_tables(obj):
    """``obj`` (a dataclass of tensors, nested) with every float32 tensor
    rounded to bfloat16."""
    if isinstance(obj, torch.Tensor):
        return _round(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name) if f.name in _KEEP
            else round_tables(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(round_tables(v) for v in obj)
    return obj


def _round_lanes(st) -> None:
    for name in ("o", "d", "beta", "radiance", "cone_width", "prev_pdf",
                 "spread"):
        setattr(st, name, round_tables(getattr(st, name)))


@contextlib.contextmanager
def bfloat16_lanes():
    """The reference's bounce with its lane state rounded to bfloat16."""
    import refpt.integrator.path as path
    original = path._bounce

    def bounce(scene, st, *args, **kwargs):
        _round_lanes(st)
        original(scene, st, *args, **kwargs)
        _round_lanes(st)
    path._bounce = bounce
    try:
        yield
    finally:
        path._bounce = original


def control_outputs(cell, traffic, device, seeds) -> list:
    """The control's outputs (on the CPU) of the units of ``seeds``."""
    from harness import impl as impls
    from harness.runner import _to_cpu
    ref = impls.reference()
    scene, cam, st = ref.load_pbrt(str(cell.scene_path()), device=device)
    drv = cells.driver(traffic["kind"]).Driver(ref, round_tables(scene),
                                               cam, st, traffic)
    drv.cam = round_tables(drv.cam)
    outs = []
    with bfloat16_lanes():
        for s in seeds:
            o, n = drv.unit(s)
            outs.append(_to_cpu(o, n))
    return outs
