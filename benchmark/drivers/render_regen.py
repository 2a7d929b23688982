"""Driver of the ``render_regen`` traffic kind: one forward
path-regeneration wave a unit, under ``torch.no_grad()``.

A unit is ``integrator.render.render_regen`` over the scene file's camera
and film: every pixel lane traces ``iterations`` iterations, starting its
pixel's next sample whenever a path ends inside the refill window, so a
wave completes about ``iterations - max_depth - 1`` samples a pixel (the
render CLI's ``--regen`` waves: ``spp`` + ``max_depth`` + 1 iterations).
The rays are counted by the timed call itself (``count_rays``).

Traffic keys: ``iterations``, ``max_depth``, ``rr_threshold``, ``nee``,
``spp_total`` (scales the regenerated rays' cone spread) and, optionally,
``film`` ([x, y]: another film through the file's camera and lens).
"""
from __future__ import annotations

import torch

from harness.spans import phase


class Driver:
    def __init__(self, impl, scene, cam, settings, traffic: dict):
        self.impl, self.scene, self.cam, self.tr = impl, scene, cam, traffic
        self.xres, self.yres = settings.xres, settings.yres
        if "film" in traffic:       # another film through the file's lens
            self.xres, self.yres = (int(x) for x in traffic["film"])
            self.cam = impl.make_perspective_camera(
                impl.from_matrix(settings.camera_to_world),
                (self.xres, self.yres), settings.fov, settings.lens_radius,
                settings.focal_dist)
        self.iterations = int(traffic["iterations"])
        self.cfg = impl.PathConfig(
            max_depth=int(traffic["max_depth"]),
            rr_threshold=float(traffic["rr_threshold"]),
            nee=bool(traffic["nee"]))

    def unit(self, seed: int, spans=None):
        """One wave: ({"film": [3, H, W] sums, "weight": [H, W] completed
        samples}, rays traced)."""
        with phase(spans, "forward"), torch.no_grad():
            film, n_rays = self.impl.render_regen(
                self.scene, self.cam, self.xres, self.yres, self.iterations,
                self.cfg, seed=seed, spp_total=int(self.tr["spp_total"]),
                count_rays=True)
            outs = {"film": torch.stack([film.r_sum, film.g_sum,
                                         film.b_sum]),
                    "weight": film.weight_sum}
        return outs, n_rays


def _rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-300))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct`` for one wave: the film's
    relative L1 gap, that of the completed samples a pixel, and the
    rays' relative gap."""
    return {
        "film_rel_l1": _rel_l1(prog["film"], ref["film"]),
        "samples_rel_l1": _rel_l1(prog["weight"], ref["weight"]),
        "rays_rel": abs(int(prog["rays"]) - int(ref["rays"]))
        / max(int(ref["rays"]), 1),
    }
