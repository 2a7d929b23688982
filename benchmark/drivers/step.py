"""Driver of the ``step`` traffic kind: one differentiable step a unit.

Frozen from ``fountain_tpu_torch/bench.py`` (commit 6354002): ``wave``,
``make_ray_fn``, ``loss_of`` and ``step`` (config 3's regeneration step)
and ``with_params``, ``flagship_forward`` and ``flagship_step`` (the
flagship's fixed-wave step), written once for either implementation. A
unit traces one wave of ``lanes`` x ``lanes`` pixel lanes through the
scene file's camera (lanes past its film leave outside its field of
view, as the TPU measured the flagship) with zero ray-cone spread, takes
the traffic's loss and its gradient with respect to leaf copies of the
tables named in ``params``. The rays are counted by the timed call
itself (``count_rays``), for each unit anew.

Traffic keys: ``wave`` ("fixed", or "regen" with ``iterations``),
``lanes``, ``max_depth``, ``rr_threshold``, ``nee``, ``estimator``
("detached" or "attached"), ``loss`` ("sum_rgb_over_3": (r.x + r.y +
r.z).sum() / 3 over the lanes; "mean_completed": the mean completed
radiance over lanes, channels and completed samples) and ``params``
(dotted paths of the scene's tables); optionally ``film`` ([x, y]:
another film through the file's camera and lens).
"""
from __future__ import annotations

import dataclasses

import torch

from harness.spans import phase


def _replace_path(obj, path: str, value):
    head, _, rest = path.partition(".")
    inner = value if not rest else _replace_path(getattr(obj, head), rest,
                                                 value)
    return dataclasses.replace(obj, **{head: inner})


def _get_path(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


class Driver:
    def __init__(self, impl, scene, cam, settings, traffic: dict):
        self.impl, self.scene, self.cam, self.tr = impl, scene, cam, traffic
        if "film" in traffic:       # another film through the file's lens
            self.cam = impl.make_perspective_camera(
                impl.from_matrix(settings.camera_to_world),
                tuple(int(x) for x in traffic["film"]), settings.fov,
                settings.lens_radius, settings.focal_dist)
        self.res = int(traffic["lanes"])
        self.regen = traffic["wave"] == "regen"
        self.iterations = int(traffic["iterations"]) if self.regen \
            else int(traffic["max_depth"]) + 1
        self.cfg = impl.PathConfig(
            max_depth=int(traffic["max_depth"]),
            rr_threshold=float(traffic["rr_threshold"]),
            nee=bool(traffic["nee"]))
        self.detach = traffic["estimator"] == "detached"
        dev = scene.device
        n = self.res * self.res
        self.lane = torch.arange(n, dtype=torch.int32, device=dev)
        self.sample = torch.zeros(n, dtype=torch.int32, device=dev)

    def _ray_fn(self, seed):
        impl, cam, res = self.impl, self.cam, self.res

        def ray_fn(lane, sample):
            px = (lane % res).to(torch.float32)
            py = torch.div(lane, res, rounding_mode="floor").to(
                torch.float32)
            u = impl.uniform4(lane, sample, impl.DIM_CAMERA, seed)
            rays = impl.generate_rays(cam, px + u[0], py + u[1], u[2], u[3])
            return rays.o, rays.d, torch.zeros_like(px)
        return ray_fn

    def unit(self, seed: int, spans=None):
        """One step: ({"loss", "grad.<param>"...}, rays traced)."""
        leaves = {p: _get_path(self.scene, p).detach().clone()
                  .requires_grad_(True) for p in self.tr["params"]}
        scene = self.scene
        for p, leaf in leaves.items():
            scene = _replace_path(scene, p, leaf)
        with phase(spans, "forward"):
            ray_fn = self._ray_fn(seed)
            o, d, _ = ray_fn(self.lane, self.sample)
            out = self.impl.trace_paths(
                scene, o, d, self.lane, self.sample, self.cfg, seed=seed,
                detach_sampling=self.detach, count_rays=True,
                regen_fn=ray_fn if self.regen else None,
                n_iters=self.iterations if self.regen else None)
            if self.regen:
                r, n_rays = out.accum, out.n_rays
            else:
                r, n_rays = out
            total = (r.x + r.y + r.z).sum()
            if self.tr["loss"] == "sum_rgb_over_3":
                loss = total / 3.0
            elif self.tr["loss"] == "mean_completed":
                loss = total / (3.0 * out.n_done.sum().clamp_min(1).to(
                    torch.float32))
            else:
                raise ValueError(f"unknown loss {self.tr['loss']!r}")
        with phase(spans, "backward"):
            loss.backward()
        outs = {"loss": loss.detach()}
        outs.update({f"grad.{p}": leaf.grad for p, leaf in leaves.items()})
        return outs, n_rays


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct`` for one unit: the loss's
    relative gap, the worst table's relative L2 gap of the gradient, and
    the rays' relative gap."""
    grads = [k for k in ref if k.startswith("grad.")]
    return {
        "loss_rel": abs(float(prog["loss"]) - float(ref["loss"]))
        / max(abs(float(ref["loss"])), 1e-300),
        "grad_rel_l2": max(_rel_l2(prog[k], ref[k]) for k in grads),
        "rays_rel": abs(int(prog["rays"]) - int(ref["rays"]))
        / max(int(ref["rays"]), 1),
    }
