# Frozen copy of fountain_tpu_torch/io/pbrt.py (commit 6354002): the benchmark's plain reference; edit never.
"""PBRT-v3 scene-file frontend (host side).

Counterpart of ``fountain_tpu/io/pbrt.py``: the tokenizer, ``ParamSet``,
the stack-machine ``PbrtParser`` and ``load_pbrt``, building through the
port's ``SceneBuilder`` and ``attach_bvh``: every shape (sphere,
trianglemesh, plymesh, loopsubdiv), every light (point, distant, infinite,
and diffuse area lights on any shape), the five materials and every
texture class of the JAX package. ObjectBegin/ObjectInstance and
participating media are rejected, as in the JAX package.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from refpt.scene.build import SceneBuilder

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def tokenize(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        out.extend(_TOKEN_RE.findall(line))
    return out


def _is_quoted(tok: str) -> bool:
    return tok.startswith('"')


def _unquote(tok: str) -> str:
    return tok[1:-1]


class _Stream:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def numbers(self, n: int) -> List[float]:
        return [float(self.next()) for _ in range(n)]

    def param_list(self) -> Dict[str, Tuple[str, list]]:
        """Parse `"type name" [v...]` pairs until a non-quoted token.
        Returns {name: (type, values)}."""
        params: Dict[str, Tuple[str, list]] = {}
        while True:
            tok = self.peek()
            if tok is None or not _is_quoted(tok):
                return params
            decl = _unquote(self.next()).split()
            if len(decl) != 2:
                raise ValueError(f"bad param declaration {decl}")
            ptype, name = decl
            vals: list = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    vals.append(self.next())
                self.next()
            else:
                vals.append(self.next())
            if ptype in ("string", "texture"):
                vals = [_unquote(v) if _is_quoted(v) else v for v in vals]
            elif ptype == "bool":
                vals = [(_unquote(v) if _is_quoted(v) else v) == "true"
                        for v in vals]
            elif ptype == "integer":
                vals = [int(v) for v in vals]
            else:
                vals = [float(v) for v in vals]
            params[name] = (ptype, vals)
        return params


class ParamSet:
    """Typed parameter lookup with texture/constant coercion
    """

    def __init__(self, raw: Dict[str, Tuple[str, list]]):
        self.raw = raw

    def get(self, name, default=None):
        if name not in self.raw:
            return default
        ptype, vals = self.raw[name]
        if ptype in ("integer", "float", "string", "bool", "texture"):
            return vals[0] if len(vals) == 1 else vals
        return vals

    def get_vec3(self, name, default=None):
        if name not in self.raw:
            return default
        _, vals = self.raw[name]
        if len(vals) == 1:
            return [float(vals[0])] * 3
        return [float(v) for v in vals[:3]]

    def get_all_vec3(self, name):
        _, vals = self.raw[name]
        return np.asarray(vals, np.float32).reshape(-1, 3)

    def get_all_vec2(self, name):
        _, vals = self.raw[name]
        return np.asarray(vals, np.float32).reshape(-1, 2)

    def get_all_int(self, name):
        _, vals = self.raw[name]
        return np.asarray(vals, np.int32)

    def is_texture(self, name) -> bool:
        return name in self.raw and self.raw[name][0] == "texture"


# ---------------------------------------------------------------------------
# Transform helpers (pure numpy)
# ---------------------------------------------------------------------------


def _np_translate(d):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    return m


def _np_scale(s):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def _np_rotate(angle_deg, axis):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(angle_deg)
    s, c = np.sin(t), np.cos(t)
    x, y, z = a
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s,
         x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c,
         y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s,
         z * z + (1 - z * z) * c]]
    return m.astype(np.float32)


def _np_look_at(eye, look, up):
    eye = np.asarray(eye, np.float64)
    d = np.asarray(look, np.float64) - eye
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    right = np.cross(up, d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m.astype(np.float32)  # camera-to-world


# ---------------------------------------------------------------------------
# Scene compilation
# ---------------------------------------------------------------------------


@dataclass
class GraphicsState:
    """Graphics-state stack entry."""
    material: int = -1
    area_light: Optional[list] = None   # pending emit rgb
    reverse_orientation: bool = False
    textures_f: Dict[str, int] = field(default_factory=dict)
    textures_s: Dict[str, int] = field(default_factory=dict)

    def clone(self):
        return GraphicsState(self.material, self.area_light,
                             self.reverse_orientation,
                             dict(self.textures_f), dict(self.textures_s))


@dataclass
class RenderSettings:
    xres: int = 640
    yres: int = 480
    spp: int = 16
    max_depth: int = 5
    integrator: str = "path"
    filter_name: str = "box"
    filter_radius: float = 0.5
    fov: float = 90.0
    lens_radius: float = 0.0
    focal_dist: float = 1e6
    camera_to_world: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    output: str = "render.exr"


class PbrtParser:
    """Stack-machine evaluator of header and world statements."""

    def __init__(self, base_dir: str = "."):
        self.base_dir = base_dir
        self.builder = SceneBuilder()
        self.settings = RenderSettings()
        self.ctm = np.eye(4, dtype=np.float32)
        self.ctm_stack: List[np.ndarray] = []
        self.gs = GraphicsState()
        self.gs_stack: List[GraphicsState] = []
        self.in_world = False
        self._image_cache: Dict[str, int] = {}

    # -- public entry

    def parse_file(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as fh:
            text = fh.read()
        return self.parse_string(text)

    def parse_string(self, text: str):
        s = _Stream(tokenize(text))
        while s.peek() is not None:
            self._stmt(s)
        return self.builder, self.settings

    # -- statement dispatch

    def _stmt(self, s: _Stream):
        kw = s.next()
        handler = getattr(self, f"_h_{kw.lower()}", None)
        if handler is None:
            raise ValueError(f"unsupported PBRT statement: {kw}")
        handler(s)

    # transforms (header + world)
    def _h_identity(self, s):
        self.ctm = np.eye(4, dtype=np.float32)

    def _h_translate(self, s):
        self.ctm = self.ctm @ _np_translate(s.numbers(3))

    def _h_scale(self, s):
        self.ctm = self.ctm @ _np_scale(s.numbers(3))

    def _h_rotate(self, s):
        v = s.numbers(4)
        self.ctm = self.ctm @ _np_rotate(v[0], v[1:])

    def _h_lookat(self, s):
        v = s.numbers(9)
        cam2world = _np_look_at(v[0:3], v[3:6], v[6:9])
        # CTM becomes world-to-camera (PBRT semantics)
        self.ctm = self.ctm @ np.linalg.inv(cam2world).astype(np.float32)

    def _h_transform(self, s):
        assert s.next() == "["
        vals = []
        while s.peek() != "]":
            vals.append(float(s.next()))
        s.next()
        self.ctm = np.asarray(vals, np.float32).reshape(4, 4).T  # column-major

    def _h_concattransform(self, s):
        assert s.next() == "["
        vals = []
        while s.peek() != "]":
            vals.append(float(s.next()))
        s.next()
        self.ctm = self.ctm @ np.asarray(vals, np.float32).reshape(4, 4).T

    def _h_coordinatesystem(self, s):
        s.next()  # name; not retained

    # header statements
    def _h_camera(self, s):
        name = _unquote(s.next())
        p = ParamSet(s.param_list())
        if name not in ("perspective",):
            raise ValueError(f"unsupported camera {name}")
        self.settings.fov = float(p.get("fov", 90.0))
        self.settings.lens_radius = float(p.get("lensradius", 0.0))
        self.settings.focal_dist = float(p.get("focaldistance", 1e6))
        self.settings.camera_to_world = np.linalg.inv(self.ctm).astype(
            np.float32)

    def _h_film(self, s):
        s.next()  # "image"
        p = ParamSet(s.param_list())
        self.settings.xres = int(p.get("xresolution", 640))
        self.settings.yres = int(p.get("yresolution", 480))
        self.settings.output = p.get("filename", "render.exr")

    def _h_sampler(self, s):
        s.next()
        p = ParamSet(s.param_list())
        self.settings.spp = int(p.get("pixelsamples", 16))

    def _h_integrator(self, s):
        self.settings.integrator = _unquote(s.next())
        p = ParamSet(s.param_list())
        self.settings.max_depth = int(p.get("maxdepth", 5))

    def _h_pixelfilter(self, s):
        self.settings.filter_name = _unquote(s.next())
        p = ParamSet(s.param_list())
        box = self.settings.filter_name == "box"
        self.settings.filter_radius = float(
            p.get("xwidth", 0.5 if box else 2.0))

    def _h_accelerator(self, s):
        s.next()
        s.param_list()  # parsed, build always uses the LBVH

    # world structure
    def _h_worldbegin(self, s):
        self.in_world = True
        self.ctm = np.eye(4, dtype=np.float32)

    def _h_worldend(self, s):
        pass

    def _h_attributebegin(self, s):
        self.gs_stack.append(self.gs.clone())
        self.ctm_stack.append(self.ctm.copy())

    def _h_attributeend(self, s):
        self.gs = self.gs_stack.pop()
        self.ctm = self.ctm_stack.pop()

    def _h_transformbegin(self, s):
        self.ctm_stack.append(self.ctm.copy())

    def _h_transformend(self, s):
        self.ctm = self.ctm_stack.pop()

    def _h_reverseorientation(self, s):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    def _h_include(self, s):
        rel = _unquote(s.next())
        with open(os.path.join(self.base_dir, rel)) as fh:
            sub = _Stream(tokenize(fh.read()))
        while sub.peek() is not None:
            self._stmt(sub)

    def _h_objectbegin(self, s):
        raise NotImplementedError(
            "ObjectBegin/ObjectInstance and participating media are not "
            "supported (nor in the JAX package)")

    _h_objectinstance = _h_objectbegin
    _h_makenamedmedium = _h_objectbegin
    _h_mediuminterface = _h_objectbegin

    # appearance
    def _tex_param(self, p: ParamSet, name, default):
        """Texture-or-constant coercion."""
        if p.is_texture(name):
            tname = p.get(name)
            tid = self.gs.textures_s.get(tname, self.gs.textures_f.get(tname))
            if tid is None:
                raise ValueError(f"unknown texture {tname}")
            return tid
        v = p.get_vec3(name, None)
        if v is None:
            return self.builder.add_constant_texture(default)
        return self.builder.add_constant_texture(v)

    def _h_material(self, s):
        name = _unquote(s.next())
        p = ParamSet(s.param_list())
        b = self.builder
        if name == "matte":
            mid = b._add_mat(
                mtype=0, kd_tex=self._tex_param(p, "Kd", [0.5] * 3),
                sigma_tex=self._tex_param(p, "sigma", [0.0] * 3))
        elif name == "mirror":
            mid = b._add_mat(
                mtype=1, kr_tex=self._tex_param(p, "Kr", [0.9] * 3))
        elif name == "glass":
            rough_u = self._tex_param(p, "uroughness",
                                      [float(p.get("roughness", 0.0))] * 3)
            rough_v = self._tex_param(p, "vroughness",
                                      [float(p.get("roughness", 0.0))] * 3)
            mid = b._add_mat(
                mtype=2, kr_tex=self._tex_param(p, "Kr", [1.0] * 3),
                kt_tex=self._tex_param(p, "Kt", [1.0] * 3),
                eta=float(p.get("eta", p.get("index", 1.5))),
                rough_u_tex=rough_u, rough_v_tex=rough_v,
                remap_roughness=bool(p.get("remaproughness", True)))
        elif name == "metal":
            # default copper (pbrt)
            rough = [float(p.get("roughness", 0.01))] * 3
            mid = b._add_mat(
                mtype=3,
                eta3=p.get_vec3("eta", [0.2004, 0.9228, 1.102]),
                k3=p.get_vec3("k", [3.913, 2.448, 2.137]),
                rough_u_tex=self._tex_param(p, "uroughness", rough),
                rough_v_tex=self._tex_param(p, "vroughness", rough),
                remap_roughness=bool(p.get("remaproughness", True)))
        elif name == "plastic":
            mid = b._add_mat(
                mtype=4, kd_tex=self._tex_param(p, "Kd", [0.25] * 3),
                ks_tex=self._tex_param(p, "Ks", [0.25] * 3),
                rough_u_tex=self._tex_param(p, "roughness", [0.1] * 3),
                remap_roughness=bool(p.get("remaproughness", True)))
        elif name in ("none", ""):
            mid = -1
        else:
            raise ValueError(f"unsupported material {name} "
                             "(matte, mirror, glass, metal, plastic)")
        self.gs.material = mid

    def _h_texture(self, s):
        tname = _unquote(s.next())
        ttype = _unquote(s.next())     # "float" | "spectrum" | "color"
        tclass = _unquote(s.next())
        p = ParamSet(s.param_list())
        b = self.builder
        if tclass == "constant":
            tid = b.add_constant_texture(p.get_vec3("value", [1.0] * 3))
        elif tclass == "scale":
            inner = self._tex_param(p, "tex1", [1.0] * 3)
            tid = b.add_scale_texture(inner, p.get_vec3("tex2", [1.0] * 3))
        elif tclass == "checkerboard":
            t1 = self._tex_param(p, "tex1", [1.0] * 3)
            t2 = self._tex_param(p, "tex2", [0.0] * 3)
            tid = b.add_checkerboard_texture(
                t1, t2, uscale=float(p.get("uscale", 1.0)),
                vscale=float(p.get("vscale", 1.0)))
        elif tclass == "uv":
            tid = b.add_uv_texture()
        elif tclass == "imagemap":
            tid = self._imagemap(p)
        else:
            raise ValueError(f"unsupported texture class {tclass} "
                             "(constant, scale, checkerboard, uv, "
                             "imagemap)")
        if ttype == "float":
            self.gs.textures_f[tname] = tid
        else:
            self.gs.textures_s[tname] = tid

    def _imagemap(self, p: ParamSet) -> int:
        fname = p.get("filename")
        path = os.path.join(self.base_dir, fname)
        if path not in self._image_cache:
            from refpt.io.image import load_image
            img = load_image(path)
            self._image_cache[path] = self.builder.add_image(img)
        return self.builder.add_image_texture(
            self._image_cache[path],
            uscale=float(p.get("uscale", 1.0)),
            vscale=float(p.get("vscale", 1.0)),
            uoffset=float(p.get("udelta", 0.0)),
            voffset=float(p.get("vdelta", 0.0)))

    # lights
    def _h_arealightsource(self, s):
        name = _unquote(s.next())
        p = ParamSet(s.param_list())
        if name != "diffuse":
            raise ValueError(f"unsupported area light {name}")
        self.gs.area_light = p.get_vec3("L", [1.0] * 3)

    def _h_lightsource(self, s):
        name = _unquote(s.next())
        p = ParamSet(s.param_list())
        b = self.builder
        if name == "point":
            pos = self.ctm @ np.asarray(
                p.get_vec3("from", [0.0] * 3) + [1.0], np.float32)
            scale = p.get_vec3("scale", [1.0] * 3)
            intensity = np.asarray(p.get_vec3("I", [1.0] * 3)) * scale
            b.add_point_light(pos[:3], intensity)
        elif name == "distant":
            frm = np.asarray(p.get_vec3("from", [0.0] * 3), np.float32)
            to = np.asarray(p.get_vec3("to", [0.0, 0.0, 1.0]), np.float32)
            w_from = (self.ctm @ np.append(frm, 1.0))[:3]
            w_to = (self.ctm @ np.append(to, 1.0))[:3]
            b.add_distant_light(w_to - w_from, p.get_vec3("L", [1.0] * 3))
        elif name == "infinite":
            env_tex = -1
            if p.get("mapname"):
                env_tex = self._imagemap(ParamSet(
                    {"filename": ("string", [p.get("mapname")])}))
            b.add_infinite_light(p.get_vec3("L", [1.0] * 3), env_tex=env_tex)
        else:
            raise ValueError(f"unsupported light {name}")

    # shapes
    def _h_shape(self, s):
        name = _unquote(s.next())
        p = ParamSet(s.param_list())
        b = self.builder
        mat = self.gs.material
        mid = None
        if mat == -1 and self.gs.area_light is None:
            mat = b.add_matte()  # pbrt default material
        if name == "sphere":
            radius = float(p.get("radius", 1.0))
            sid = b.add_sphere(
                radius=radius, o2w=self.ctm, mat_id=mat,
                reverse_orientation=self.gs.reverse_orientation,
                z_min=p.get("zmin"), z_max=p.get("zmax"),
                phi_max_deg=float(p.get("phimax", 360.0)))
            if self.gs.area_light is not None:
                b.add_area_light_sphere(sid, self.gs.area_light)
        elif name == "trianglemesh":
            positions = p.get_all_vec3("P")
            indices = p.get_all_int("indices").reshape(-1, 3)
            normals = p.get_all_vec3("N") if "N" in p.raw else None
            uv = None
            for key in ("uv", "st"):
                if key in p.raw:
                    uv = p.get_all_vec2(key)
            mid = b.add_triangle_mesh(
                positions, indices, normals=normals, uv=uv, mat_id=mat,
                reverse_orientation=self.gs.reverse_orientation, o2w=self.ctm)
        elif name == "loopsubdiv":
            from refpt.geometry.loop_subdiv import loop_subdivide
            positions = p.get_all_vec3("P")
            indices = p.get_all_int("indices").reshape(-1, 3)
            levels = int(p.get("levels", p.get("nlevels", 3)))
            pos_s, idx_s, nrm_s = loop_subdivide(positions, indices, levels)
            mid = b.add_triangle_mesh(
                pos_s, idx_s, normals=nrm_s, mat_id=mat,
                reverse_orientation=self.gs.reverse_orientation, o2w=self.ctm)
        elif name == "plymesh":
            from refpt.io.ply import load_ply
            mesh = load_ply(os.path.join(self.base_dir, p.get("filename")))
            mid = b.add_triangle_mesh(
                mesh.positions, mesh.indices, normals=mesh.normals,
                uv=mesh.uv, mat_id=mat,
                reverse_orientation=self.gs.reverse_orientation, o2w=self.ctm)
        else:
            raise ValueError(f"unsupported shape {name}")
        if mid is not None and self.gs.area_light is not None:
            b.add_area_light_mesh(mid, self.gs.area_light)


def load_pbrt(path: str, device=None):
    """Parse a .pbrt file -> (scene, camera, settings). The scene lives on
    ``device`` (default cuda; raises without a card) with its leaf order
    and sweep tables attached; the camera is ready for rendering."""
    from refpt.core import transform as tf
    from refpt.geometry.bvh import attach_bvh
    from refpt.scene.camera import make_perspective_camera

    parser = PbrtParser()
    builder, st = parser.parse_file(path)
    scene = attach_bvh(builder.build(device=device))
    cam = make_perspective_camera(
        tf.from_matrix(st.camera_to_world), (st.xres, st.yres),
        fov_deg=st.fov, lens_radius=st.lens_radius,
        focal_dist=st.focal_dist)
    return scene, cam, st
