"""The two implementations a driver runs: the program under test and the
benchmark's plain reference. Each is a namespace of the same names, so
one driver runs either; the reference's imports touch nothing of the
program."""
from __future__ import annotations

from types import SimpleNamespace


def port() -> SimpleNamespace:
    """fountain_tpu_torch, the program under test."""
    from fountain_tpu_torch.core.rng import uniform4
    from fountain_tpu_torch.core.transform import from_matrix
    from fountain_tpu_torch.geometry import intersect
    from fountain_tpu_torch.integrator.path import (DIM_CAMERA, PathConfig,
                                                    trace_paths)
    from fountain_tpu_torch.integrator.render import render_regen
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.camera import (generate_rays,
                                                 make_perspective_camera)
    return SimpleNamespace(
        name="port", load_pbrt=load_pbrt, trace_paths=trace_paths,
        PathConfig=PathConfig, DIM_CAMERA=DIM_CAMERA, uniform4=uniform4,
        generate_rays=generate_rays, render_regen=render_regen,
        intersect=intersect, from_matrix=from_matrix,
        make_perspective_camera=make_perspective_camera)


def reference() -> SimpleNamespace:
    """refpt, the frozen plain reference (benchmark/refpt)."""
    from refpt.core.rng import uniform4
    from refpt.core.transform import from_matrix
    from refpt.geometry import intersect
    from refpt.integrator.path import DIM_CAMERA, PathConfig, trace_paths
    from refpt.integrator.render import render_regen
    from refpt.io.pbrt import load_pbrt
    from refpt.scene.camera import generate_rays, make_perspective_camera
    return SimpleNamespace(
        name="reference", load_pbrt=load_pbrt, trace_paths=trace_paths,
        PathConfig=PathConfig, DIM_CAMERA=DIM_CAMERA, uniform4=uniform4,
        generate_rays=generate_rays, render_regen=render_regen,
        intersect=intersect, from_matrix=from_matrix,
        make_perspective_camera=make_perspective_camera)
