# Frozen copy of fountain_tpu_torch/scene/build.py (commit 6354002): the benchmark's plain reference; edit never.
"""Host-side scene assembly (SceneBuilder) and the bridge from JAX leaves.

Counterpart of ``fountain_tpu/scene/build.py``: images, every texture
type (constant, uv, image, checker, scale), the five materials, triangle
meshes (with object-to-world transforms), spheres, and every light type
(point, distant, infinite, sphere and mesh area lights). ``build()``
compiles the rows into a ``Scene`` of tensors on the chosen device, with
the world bounds, the mipmapped image atlas, the per-light env alias
tables and the mesh lights' per-face alias table ``light_tri``.

``scene_from_arrays`` turns the leaves of a ``fountain_tpu`` Scene (given
as numpy arrays under their dotted field paths) into the port's Scene, so
tests trace identical tables in both packages without this package
importing JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from refpt.device import resolve_device
from refpt.scene.types import (LIGHT_AREA_SPHERE,
                                            LIGHT_AREA_TRI, LIGHT_DISTANT,
                                            LIGHT_INFINITE, LIGHT_POINT,
                                            MAT_GLASS,
                                            MAT_MATTE, MAT_METAL, MAT_MIRROR,
                                            MAT_PLASTIC, TEX_CHECKER,
                                            TEX_CONSTANT, TEX_IMAGE,
                                            TEX_SCALE, TEX_UV, Lights,
                                            Materials, Scene, Spheres,
                                            Textures, Triangles)

_I4 = np.eye(4, dtype=np.float32)
# a material row's defaults (texture id 0 is the reserved black constant)
_MAT_ROW = dict(mtype=MAT_MATTE, kd_tex=0, ks_tex=0, kr_tex=0, kt_tex=0,
                sigma_tex=0, rough_u_tex=0, rough_v_tex=0, eta=1.5,
                eta3=[1.0, 1.0, 1.0], k3=[1.0, 1.0, 1.0],
                remap_roughness=True)


def _empty_spheres(device) -> Spheres:
    z = torch.zeros((0,), dtype=torch.float32, device=device)
    m = torch.zeros((0, 4, 4), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    return Spheres(o2w=m, w2o=m, radius=z, z_min=z, z_max=z, phi_max=z,
                   mat_id=zi, light_id=zi,
                   flip_normal=torch.zeros((0,), dtype=torch.bool,
                                           device=device))


def _env_density(img: np.ndarray) -> np.ndarray:
    """Env-map sampling density: luminance * sin(theta), tent-convolved
    ([1/8, 3/4, 1/8], wrap in u, clamp in v) so pdf > 0 wherever the
    bilerped radiance is > 0. Row 0 is the image bottom (v = 0)."""
    lum = (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
           + 0.072169 * img[..., 2])
    k = np.array([0.125, 0.75, 0.125], np.float32)
    pad = np.concatenate([lum[:, -1:], lum, lum[:, :1]], axis=1)
    lum_u = k[0] * pad[:, :-2] + k[1] * pad[:, 1:-1] + k[2] * pad[:, 2:]
    pad = np.concatenate([lum_u[:1], lum_u, lum_u[-1:]], axis=0)
    return k[0] * pad[:-2] + k[1] * pad[1:-1] + k[2] * pad[2:]


class SceneBuilder:
    def __init__(self):
        self._tex = []
        self._mat = []
        self._lights = []
        self._spheres = []
        self._tri_meshes = []
        self._images = []
        self._image_wraps = []
        # texture id 0 is reserved "black"
        self.add_constant_texture([0.0, 0.0, 0.0])

    def add_image(self, img, wrap: int = 0) -> int:
        """Register a raw [H, W, 3] linear image; returns its atlas id."""
        self._images.append(np.asarray(img, np.float32))
        self._image_wraps.append(int(wrap))
        return len(self._images) - 1

    def _add_tex(self, **kw) -> int:
        row = dict(ttype=TEX_CONSTANT, value=[0.0, 0.0, 0.0], sub_a=0,
                   sub_b=0, uv_scale=[1.0, 1.0], uv_offset=[0.0, 0.0],
                   image_id=-1)
        row.update(kw)
        self._tex.append(row)
        return len(self._tex) - 1

    def add_constant_texture(self, value) -> int:
        value = np.broadcast_to(np.asarray(value, np.float32), (3,)).tolist()
        return self._add_tex(ttype=TEX_CONSTANT, value=value)

    def add_checkerboard_texture(self, tex1: int, tex2: int,
                                 uscale=1.0, vscale=1.0) -> int:
        return self._add_tex(ttype=TEX_CHECKER, sub_a=tex1, sub_b=tex2,
                             uv_scale=[uscale, vscale])

    def add_uv_texture(self) -> int:
        return self._add_tex(ttype=TEX_UV)

    def add_scale_texture(self, inner: int, factor) -> int:
        factor = np.broadcast_to(np.asarray(factor, np.float32),
                                 (3,)).tolist()
        return self._add_tex(ttype=TEX_SCALE, sub_a=inner, value=factor)

    def add_image_texture(self, image_id: int, uscale=1.0, vscale=1.0,
                          uoffset=0.0, voffset=0.0) -> int:
        return self._add_tex(ttype=TEX_IMAGE, image_id=image_id,
                             uv_scale=[uscale, vscale],
                             uv_offset=[uoffset, voffset])

    def _tex_or_const(self, v) -> int:
        """A texture id (int) as it is, or a constant value's new id."""
        if isinstance(v, (int, np.integer)):
            return int(v)
        return self.add_constant_texture(v)

    def _add_mat(self, **kw) -> int:
        self._mat.append(dict(_MAT_ROW, **kw))
        return len(self._mat) - 1

    def add_matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0) -> int:
        return self._add_mat(mtype=MAT_MATTE, kd_tex=self._tex_or_const(kd),
                             sigma_tex=self._tex_or_const([sigma] * 3))

    def add_mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        return self._add_mat(mtype=MAT_MIRROR, kr_tex=self._tex_or_const(kr))

    def add_glass(self, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5,
                  rough_u=0.0, rough_v=0.0, remap=True) -> int:
        return self._add_mat(
            mtype=MAT_GLASS, kr_tex=self._tex_or_const(kr),
            kt_tex=self._tex_or_const(kt), eta=float(eta),
            rough_u_tex=self._tex_or_const([rough_u] * 3),
            rough_v_tex=self._tex_or_const([rough_v] * 3),
            remap_roughness=remap)

    def add_metal(self, eta3=(0.2, 0.92, 1.1), k3=(3.9, 2.45, 2.14),
                  roughness=0.01, rough_u=None, rough_v=None,
                  remap=True) -> int:
        """``rough_u`` / ``rough_v`` (default ``roughness``) are values or
        texture ids."""
        ru = roughness if rough_u is None else rough_u
        rv = roughness if rough_v is None else rough_v
        return self._add_mat(
            mtype=MAT_METAL, eta3=list(map(float, eta3)),
            k3=list(map(float, k3)), rough_u_tex=self._tex_or_const(ru),
            rough_v_tex=self._tex_or_const(rv), remap_roughness=remap)

    def add_plastic(self, kd=(0.25, 0.25, 0.25), ks=(0.25, 0.25, 0.25),
                    roughness=0.1, remap=True) -> int:
        return self._add_mat(
            mtype=MAT_PLASTIC, kd_tex=self._tex_or_const(kd),
            ks_tex=self._tex_or_const(ks),
            rough_u_tex=self._tex_or_const([roughness] * 3),
            remap_roughness=remap)

    def add_sphere(self, radius=1.0, o2w=None, mat_id=-1,
                   reverse_orientation=False, z_min=None, z_max=None,
                   phi_max_deg=360.0) -> int:
        """A sphere of ``radius`` about the origin of its object space;
        ``o2w`` [4, 4] maps object to world (identity by default)."""
        o2w = _I4 if o2w is None else np.asarray(o2w, np.float32)
        swaps = np.linalg.det(o2w[:3, :3]) < 0
        self._spheres.append(dict(
            o2w=o2w, w2o=np.linalg.inv(o2w).astype(np.float32),
            radius=float(radius),
            z_min=-radius if z_min is None else float(z_min),
            z_max=radius if z_max is None else float(z_max),
            phi_max=float(np.deg2rad(phi_max_deg)),
            mat_id=int(mat_id), light_id=-1,
            flip_normal=bool(reverse_orientation) ^ bool(swaps)))
        return len(self._spheres) - 1

    def add_triangle_mesh(self, positions, indices, normals=None, uv=None,
                          mat_id=-1, reverse_orientation=False,
                          o2w=None) -> int:
        """Positions [V,3] (object space if ``o2w`` [4, 4] is given: they
        are transformed here, before the leaf order is built, and the
        normals by the inverse transpose), indices [F,3]."""
        positions = np.asarray(positions, np.float32)
        swaps = False
        if o2w is not None:
            o2w = np.asarray(o2w, np.float32)
            swaps = bool(np.linalg.det(o2w[:3, :3]) < 0)
            positions = positions @ o2w[:3, :3].T + o2w[:3, 3]
            if normals is not None:
                nrm_m = np.linalg.inv(o2w[:3, :3]).T
                normals = np.asarray(normals, np.float32) @ nrm_m.T
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            ln = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = normals / np.maximum(ln, 1e-20)
        self._tri_meshes.append(dict(
            positions=positions, indices=np.asarray(indices, np.int32),
            normals=normals, uv=uv, mat_id=int(mat_id), light_id=-1,
            flip_normal=bool(reverse_orientation) ^ swaps))
        return len(self._tri_meshes) - 1

    def _add_light(self, **kw) -> int:
        row = dict(ltype=LIGHT_INFINITE, emit=[1.0, 1.0, 1.0],
                   pos=[0.0, 0.0, 0.0], dir=[0.0, 0.0, 1.0], shape_id=-1,
                   tri_start=0, tri_count=0, env_tex=-1, area=0.0)
        row.update(kw)
        self._lights.append(row)
        return len(self._lights) - 1

    def add_point_light(self, pos, intensity) -> int:
        """Isotropic point light of ``intensity`` at ``pos``."""
        return self._add_light(ltype=LIGHT_POINT, pos=list(map(float, pos)),
                               emit=list(map(float, intensity)))

    def add_distant_light(self, direction, radiance) -> int:
        """Directional light; ``direction`` points FROM the light."""
        return self._add_light(ltype=LIGHT_DISTANT,
                               dir=list(map(float, direction)),
                               emit=list(map(float, radiance)))

    def add_infinite_light(self, radiance=(1.0, 1.0, 1.0),
                           env_tex: int = -1) -> int:
        return self._add_light(ltype=LIGHT_INFINITE,
                               emit=list(map(float, radiance)),
                               env_tex=int(env_tex))

    def add_area_light_sphere(self, sphere_idx: int, radiance) -> int:
        """Diffuse emission from sphere ``sphere_idx`` (one-sided, along
        its normals)."""
        sph = self._spheres[sphere_idx]
        lid = self._add_light(ltype=LIGHT_AREA_SPHERE,
                              emit=list(map(float, radiance)),
                              shape_id=int(sphere_idx),
                              area=4.0 * np.pi * sph["radius"] ** 2)
        sph["light_id"] = lid
        return lid

    def add_area_light_mesh(self, mesh_idx: int, radiance) -> int:
        """Diffuse emission from every face of mesh ``mesh_idx`` (one-sided,
        along the faces' geometric normals); faces are sampled in
        proportion to their area."""
        lid = self._add_light(ltype=LIGHT_AREA_TRI,
                              emit=list(map(float, radiance)),
                              shape_id=int(mesh_idx))
        self._tri_meshes[mesh_idx]["light_id"] = lid
        return lid

    def build(self, device=None) -> Scene:
        """Compile the rows into a Scene on ``device`` (default cuda)."""
        dev = resolve_device(device)
        f32 = lambda a: torch.as_tensor(                      # noqa: E731
            np.asarray(a, np.float32), device=dev)
        i32 = lambda a: torch.as_tensor(                      # noqa: E731
            np.asarray(a, np.int32), device=dev)
        b8 = lambda a: torch.as_tensor(                       # noqa: E731
            np.asarray(a, bool), device=dev)

        meshes = self._tri_meshes
        v_off = np.cumsum([0] + [len(m["positions"]) for m in meshes])[:-1]
        pos_all = np.concatenate([m["positions"] for m in meshes]) \
            if meshes else np.zeros((0, 3), np.float32)
        per_face = lambda key: np.concatenate(                # noqa: E731
            [np.full(len(m["indices"]), m[key]) for m in meshes]) \
            if meshes else np.zeros((0,))
        triangles = Triangles(
            positions=f32(pos_all),
            indices=i32(np.concatenate([m["indices"] + o for m, o in
                                        zip(meshes, v_off)])
                        if meshes else np.zeros((0, 3))),
            normals=f32(np.concatenate(
                [m["normals"] if m["normals"] is not None
                 else np.zeros_like(m["positions"]) for m in meshes])
                if meshes else np.zeros((0, 3))),
            has_normals=b8(np.concatenate(
                [np.full(len(m["indices"]), m["normals"] is not None)
                 for m in meshes]) if meshes else np.zeros((0,))),
            uv=f32(np.concatenate(
                [np.asarray(m["uv"], np.float32) if m["uv"] is not None
                 else np.zeros((len(m["positions"]), 2), np.float32)
                 for m in meshes]) if meshes else np.zeros((0, 2))),
            mat_id=i32(per_face("mat_id")),
            light_id=i32(per_face("light_id")),
            flip_normal=b8(per_face("flip_normal")),
            mesh_id=i32(np.concatenate(
                [np.full(len(m["indices"]), k) for k, m in enumerate(meshes)])
                if meshes else np.zeros((0,))))

        mats = self._mat or [_MAT_ROW]
        col = lambda k: [r[k] for r in mats]                  # noqa: E731
        materials = Materials(
            **{k: i32(col(k)) for k in ("mtype", "kd_tex", "ks_tex",
                                        "kr_tex", "kt_tex", "sigma_tex",
                                        "rough_u_tex", "rough_v_tex")},
            eta=f32(col("eta")), eta3=f32(col("eta3")), k3=f32(col("k3")),
            remap_roughness=b8(col("remap_roughness")))

        tex = self._tex
        textures = Textures(
            ttype=i32([r["ttype"] for r in tex]),
            value=f32([r["value"] for r in tex]),
            sub_a=i32([r["sub_a"] for r in tex]),
            sub_b=i32([r["sub_b"] for r in tex]),
            uv_scale=f32([r["uv_scale"] for r in tex]),
            uv_offset=f32([r["uv_offset"] for r in tex]),
            image_id=i32([r["image_id"] for r in tex]),
            has_nested=any(r["ttype"] in (TEX_CHECKER, TEX_SCALE)
                           for r in tex))

        spheres = _empty_spheres(dev)
        if self._spheres:
            sp = self._spheres
            spheres = Spheres(
                o2w=f32(np.stack([r["o2w"] for r in sp])),
                w2o=f32(np.stack([r["w2o"] for r in sp])),
                **{k: f32([r[k] for r in sp])
                   for k in ("radius", "z_min", "z_max", "phi_max")},
                mat_id=i32([r["mat_id"] for r in sp]),
                light_id=i32([r["light_id"] for r in sp]),
                flip_normal=b8([r["flip_normal"] for r in sp]))

        # world bounds (bounding sphere used by infinite lights)
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for r in self._spheres:
            c = r["o2w"][:3, 3]
            rad = abs(r["radius"]) * float(
                np.linalg.norm(r["o2w"][:3, :3], 2))
            lo = np.minimum(lo, c - rad)
            hi = np.maximum(hi, c + rad)
        for m in meshes:
            if len(m["positions"]):
                lo = np.minimum(lo, m["positions"].min(0))
                hi = np.maximum(hi, m["positions"].max(0))
        if not np.all(np.isfinite(lo)):
            lo = np.zeros(3, np.float32)
            hi = np.ones(3, np.float32)
        center = (lo + hi) / 2.0
        radius = float(np.linalg.norm(hi - center))

        # image atlas + per-light env-map importance tables
        atlas = env_dist = None
        env_slots = {}
        if self._images:
            from refpt.core.sampling import make_env_alias_stack
            from refpt.shading.mipmap import build_atlas
            atlas = build_atlas(self._images, self._image_wraps, dev)
            per_light = self._env_light_images()
            if per_light:
                # common grid: nearest-upsample every map to the largest
                nv_c = max(self._images[i].shape[0] for _, i in per_light)
                nu_c = max(self._images[i].shape[1] for _, i in per_light)
                funcs = []
                for slot, (lid, img_id) in enumerate(per_light):
                    lum_b = _env_density(self._images[img_id])
                    h, w = lum_b.shape
                    if (h, w) != (nv_c, nu_c):
                        ri = np.minimum((np.arange(nv_c) * h) // nv_c, h - 1)
                        ci = np.minimum((np.arange(nu_c) * w) // nu_c, w - 1)
                        lum_b = lum_b[ri][:, ci]
                    v = (np.arange(nv_c, dtype=np.float32) + 0.5) / nv_c
                    sin_t = np.sin(np.pi * (1.0 - v))
                    funcs.append(lum_b * sin_t[:, None])
                    env_slots[lid] = slot
                env_dist = make_env_alias_stack(funcs, dev)

        lt = [dict(r) for r in self._lights]
        light_tri = self._light_tri(meshes, lt)
        n_l = len(lt)
        col = lambda k, *shape: np.asarray(                   # noqa: E731
            [r[k] for r in lt]).reshape(n_l, *shape)
        lights = Lights(
            ltype=i32(col("ltype")), emit=f32(col("emit", 3)),
            pos=f32(col("pos", 3)), dir=f32(col("dir", 3)),
            shape_id=i32(col("shape_id")), tri_start=i32(col("tri_start")),
            tri_count=i32(col("tri_count")), env_tex=i32(col("env_tex")),
            area=f32(col("area")),
            env_slot=i32([env_slots.get(i, -1) for i in range(n_l)]))

        return Scene(
            spheres=spheres, triangles=triangles,
            materials=materials, textures=textures, lights=lights,
            world_center=f32(center),
            world_radius=f32(max(radius, 1e-3)),
            light_tri=None if light_tri is None else f32(light_tri),
            env_images=atlas, env_dist=env_dist)

    @staticmethod
    def _light_tri(meshes, lt):
        """The mesh lights' [F, 16] face table in the original face order
        (``Scene.light_tri``), or None without a mesh light; fills each
        mesh light's row of ``lt`` with its face range and total area.
        Faces are chosen in proportion to their world-space area by a
        Vose alias table over the light's own range."""
        from refpt.core.sampling import vose_alias
        ranges, f_off = {}, 0
        for m in meshes:
            if m["light_id"] >= 0:
                ranges[m["light_id"]] = (f_off, len(m["indices"]))
            f_off += len(m["indices"])
        if not ranges:
            return None
        v_off = np.cumsum([0] + [len(m["positions"]) for m in meshes])[:-1]
        pos_all = np.concatenate([m["positions"] for m in meshes])
        fverts = pos_all[np.concatenate(
            [m["indices"] + o for m, o in zip(meshes, v_off)])]
        face_area = 0.5 * np.linalg.norm(
            np.cross(fverts[:, 1] - fverts[:, 0], fverts[:, 2] - fverts[:, 0]),
            axis=-1)
        table = np.zeros((len(face_area), 16), np.float32)
        table[:, 2:11] = fverts.reshape(-1, 9)
        table[:, 11] = np.concatenate(
            [np.full(len(m["indices"]), float(m["flip_normal"]), np.float32)
             for m in meshes])
        for lid, (start, cnt) in ranges.items():
            seg = face_area[start:start + cnt]
            total = max(float(seg.sum()), 1e-20)
            prob, alias = vose_alias(seg / total)
            table[start:start + cnt, 0] = prob
            table[start:start + cnt, 1] = (alias + start).astype(np.float32)
            lt[lid].update(tri_start=start, tri_count=cnt, area=total)
        return table

    def _env_light_images(self):
        """[(light_idx, image_id)] for every env-mapped infinite light,
        resolving scale nesting down to the image texture."""
        out = []
        for lid, r in enumerate(self._lights):
            if r["ltype"] != LIGHT_INFINITE or r["env_tex"] < 0:
                continue
            tid = r["env_tex"]
            for _ in range(4):
                row = self._tex[tid]
                if row["ttype"] == TEX_IMAGE:
                    out.append((lid, row["image_id"]))
                    break
                if row["ttype"] != TEX_SCALE:
                    break
                tid = row["sub_a"]
        return out


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """The port's Scene from the leaves of a ``fountain_tpu`` Scene.

    ``arrays`` maps each leaf's dotted field path to its numpy value, e.g.
    ``"triangles.positions"``, ``"textures.value"``, ``"env_dist.prob"``,
    ``"tri_attr"``. The BVH walk's node rows (``"bvh_nodes8"``) and
    leaf-ordered vertices (``"bvh_tri_verts"``) come across as they are
    (``"bvh_meta"``, where present, must agree with the rows' packed
    links and ranges), so a JAX scene above the dense budget, which has
    no ``tri_features``, keeps its BVH. The sweeps' face table takes the
    JAX package's dense coefficients (``"tri_features.packed"``) as they
    are where the scene has them (else it computes them from the
    vertices), with block bounds from the leaf-ordered vertices. The
    TPU-only table (``tri_qfeat``) and the walk's unpacked node arrays
    (``bvh_nodes_min``/``max``) are ignored.
    """
    from refpt.core.sampling import EnvAlias
    from refpt.geometry.tensor_tri import TriFeatures
    from refpt.geometry.tri_sweep import pack_sweep_table
    from refpt.shading.mipmap import ImageAtlas
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=dev)

    def group(cls, prefix, **extra):
        names = [f for f in cls.__dataclass_fields__ if f not in extra]
        return cls(**{f: t(f"{prefix}.{f}") for f in names}, **extra)

    scene = Scene(
        spheres=group(Spheres, "spheres"),
        triangles=group(Triangles, "triangles"),
        materials=group(Materials, "materials"),
        textures=group(Textures, "textures", has_nested=bool(
            np.asarray(arrays.get("textures.has_nested", [])).shape[0])),
        lights=group(Lights, "lights"),
        world_center=t("world_center"), world_radius=t("world_radius"),
        tri_attr=t("tri_attr") if "tri_attr" in arrays else None,
        light_tri=t("light_tri") if "light_tri" in arrays else None,
        env_images=group(ImageAtlas, "env_images")
        if "env_images.texels" in arrays else None,
        env_dist=group(EnvAlias, "env_dist")
        if "env_dist.prob" in arrays else None)
    if scene.triangles.count:
        feat = TriFeatures(t("tri_features.packed")) \
            if "tri_features.packed" in arrays else None
        scene.tri_sweep = pack_sweep_table(arrays["bvh_tri_verts"], dev,
                                           feat=feat)
        nodes8 = np.array(arrays["bvh_nodes8"], np.float32)
        if "bvh_meta" in arrays:
            meta = np.asarray(arrays["bvh_meta"], np.int64)
            bits = nodes8.view(np.int32)
            if not (np.array_equal(bits[:, 6], meta[:, 0]) and
                    np.array_equal(bits[:, 7], meta[:, 1] << 3 | meta[:, 2])):
                raise ValueError("bvh_meta disagrees with bvh_nodes8")
        scene.bvh_nodes8 = torch.as_tensor(nodes8, device=dev)
        scene.bvh_tri_verts = t("bvh_tri_verts")
    return scene
