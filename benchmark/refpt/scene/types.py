# Frozen copy of fountain_tpu_torch/scene/types.py (commit 6354002): the benchmark's plain reference; edit never.
"""Flat SoA scene tables as dataclasses of tensors.

Counterpart of ``fountain_tpu/scene/types.py``: the same fields and the
same ``LIGHT_*``/``MAT_*``/``TEX_*`` codes. Material, texture and light
parameter tensors are the differentiable leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

MAT_NONE = -1
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_METAL = 3
MAT_PLASTIC = 4
ALL_MATERIALS = frozenset((MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_METAL,
                           MAT_PLASTIC))

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_UV = 3
TEX_SCALE = 4

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_INFINITE = 2
LIGHT_AREA_SPHERE = 3
LIGHT_AREA_TRI = 4


@dataclass
class Spheres:
    o2w: torch.Tensor         # [S, 4, 4] object -> world
    w2o: torch.Tensor         # [S, 4, 4] world -> object
    radius: torch.Tensor      # [S]
    z_min: torch.Tensor       # [S]
    z_max: torch.Tensor       # [S]
    phi_max: torch.Tensor     # [S] radians
    mat_id: torch.Tensor      # [S] int32
    light_id: torch.Tensor    # [S] int32
    flip_normal: torch.Tensor  # [S] bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclass
class Triangles:
    positions: torch.Tensor    # [V, 3] world space
    indices: torch.Tensor      # [F, 3] int32
    normals: torch.Tensor      # [V, 3] shading normals
    has_normals: torch.Tensor  # [F] bool
    uv: torch.Tensor           # [V, 2]
    mat_id: torch.Tensor       # [F] int32
    light_id: torch.Tensor     # [F] int32 (-1 = not emissive)
    flip_normal: torch.Tensor  # [F] bool
    mesh_id: torch.Tensor      # [F] int32

    @property
    def count(self) -> int:
        return self.indices.shape[0]


@dataclass
class Materials:
    mtype: torch.Tensor        # [M] int32
    kd_tex: torch.Tensor       # [M] int32 texture id
    ks_tex: torch.Tensor
    kr_tex: torch.Tensor
    kt_tex: torch.Tensor
    sigma_tex: torch.Tensor    # Oren-Nayar sigma texture
    rough_u_tex: torch.Tensor
    rough_v_tex: torch.Tensor
    eta: torch.Tensor          # [M] dielectric ior
    eta3: torch.Tensor         # [M, 3] conductor eta
    k3: torch.Tensor           # [M, 3] conductor absorption
    remap_roughness: torch.Tensor  # [M] bool

    def __post_init__(self):
        # the material types in the table, read once to the host: shading
        # builds the lobes and sampling candidates of these types only
        self.present = frozenset(self.mtype.tolist())

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


@dataclass
class Textures:
    ttype: torch.Tensor        # [T] int32
    value: torch.Tensor        # [T, 3] constant value / scale factor
    sub_a: torch.Tensor        # [T] int32
    sub_b: torch.Tensor        # [T] int32
    uv_scale: torch.Tensor     # [T, 2]
    uv_offset: torch.Tensor    # [T, 2]
    image_id: torch.Tensor     # [T] int32 (-1 = none)
    has_nested: bool = False   # any checker/scale texture in the table

    @property
    def count(self) -> int:
        return self.ttype.shape[0]


@dataclass
class Lights:
    ltype: torch.Tensor        # [L] int32
    emit: torch.Tensor         # [L, 3]
    pos: torch.Tensor          # [L, 3]
    dir: torch.Tensor          # [L, 3]
    shape_id: torch.Tensor     # [L] int32
    tri_start: torch.Tensor    # [L] int32
    tri_count: torch.Tensor    # [L] int32
    env_tex: torch.Tensor      # [L] int32
    area: torch.Tensor         # [L]
    env_slot: torch.Tensor     # [L] int32 (-1 = uniform-sphere sampling)

    def __post_init__(self):
        # each light's type, read once to the host: sampling and pdf
        # queries build the branches of the present types only
        self.types = tuple(self.ltype.tolist())
        self.present = frozenset(self.types)

    @property
    def count(self) -> int:
        return self.ltype.shape[0]


@dataclass
class Scene:
    """The full flat scene. ``tri_sweep`` (geometry.tri_sweep.SweepTable)
    carries the triangle sweeps' face table in leaf order; ``tri_attr``
    the packed per-face hit attributes (geometry.triangle);
    ``bvh_nodes8`` [M, 8] f32 the BVH walk's node rows (min.xyz, max.xyz,
    then the miss link and first << 3 | count as int32 bit patterns,
    geometry.bvh.pack_nodes) and ``bvh_tri_verts`` [F, 3, 3] f32 the
    faces' vertices in leaf order. ``light_tri``
    [F, 16] is the mesh area lights' face table in SceneBuilder's ORIGINAL
    face order (a light addresses its faces as the range [tri_start,
    tri_start + tri_count), whatever the leaf order): 0 alias
    probability | 1 alias face (as a float) | 2:11 the face's vertices p0,
    p1, p2 | 11 flip | 12:16 zero; None when no light samples mesh
    faces."""
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    textures: Textures
    lights: Lights
    world_center: torch.Tensor   # [3]
    world_radius: torch.Tensor   # []
    tri_sweep: Optional[object] = None
    tri_attr: Optional[torch.Tensor] = None
    bvh_nodes8: Optional[torch.Tensor] = None
    bvh_tri_verts: Optional[torch.Tensor] = None
    light_tri: Optional[torch.Tensor] = None
    env_images: Optional[object] = None   # shading.mipmap.ImageAtlas
    env_dist: Optional[object] = None     # core.sampling.EnvAlias

    @property
    def device(self) -> torch.device:
        return self.world_center.device
