"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without one. This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.geometry import tri_sweep as ts

T_RTOL = 3e-5   # f32 dots summed in another order than the plain matmul


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# two copies of one triangle at these face indices (leaf order)
COINCIDENT = {"one_block": (5, 9), "two_blocks": (5, 130)}


def coincident_case(where, n_rays=256, seed=0):
    """200 faces, two of them the same triangle (z = 0, the unit right
    triangle) at the indices COINCIDENT[where]; the others lie behind it
    (z < -10). Rays start at z = 5 above the triangle's interior and point
    down, so each hits both copies at t = 5: the lower index must win."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (200, 3)) + np.array([0.0, 0.0, -20.0])
    tv = np.stack([v0, v0 + rng.uniform(-1, 1, (200, 3)),
                   v0 + rng.uniform(-1, 1, (200, 3))], 1)
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for k in COINCIDENT[where]:
        tv[k] = tri
    uv = rng.uniform(0.05, 0.45, (n_rays, 2))
    o = np.concatenate([uv, np.full((n_rays, 1), 5.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (n_rays, 1))
    return (tv.astype(np.float32), o.astype(np.float32),
            d.astype(np.float32))


def shadow_case(n_tris, n_rays, seed, live_share=0.1):
    """Shadow rays in the main path's own form: unnormalised directions
    target - o, caps 1 - SHADOW_EPSILON, and about 90% of the lanes dead
    (cap -1). Returns (faces, o, d, t_max) as numpy arrays."""
    from fountain_tpu_torch.core.vecmath import SHADOW_EPSILON
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (n_tris, 3))
    tv = np.stack([v0, v0 + rng.uniform(-1, 1, (n_tris, 3)),
                   v0 + rng.uniform(-1, 1, (n_tris, 3))], 1)
    o = rng.uniform(-12, 12, (n_rays, 3))
    target = rng.uniform(-12, 12, (n_rays, 3))
    live = rng.uniform(size=n_rays) < live_share
    t_max = np.where(live, 1.0 - SHADOW_EPSILON, -1.0)
    return (tv.astype(np.float32), o.astype(np.float32),
            (target - o).astype(np.float32), t_max.astype(np.float32))


def _on_card(a):
    return V3(*[torch.as_tensor(a[:, k].copy(), device="cuda")
                for k in range(3)])


def _random_case(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (n_tris, 3)).astype(np.float32)
    tv = np.stack([v0, v0 + rng.uniform(-1, 1, (n_tris, 3)),
                   v0 + rng.uniform(-1, 1, (n_tris, 3))], 1)
    o = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cuda = lambda a: V3(*[torch.as_tensor(a[:, k].copy(), device="cuda")
                          for k in range(3)])                  # noqa: E731
    return tv.astype(np.float32), cuda(o), cuda(d)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(monkeypatch):
    """Both kernels equal their plain versions (hit masks and idx equal, t
    within rtol 3e-5, any-hit equal), count their launches, and a CUDA
    tensor never reaches the plain version."""
    _card()
    tv, o, d = _random_case(1024 + 3 * 128 + 17, 1024, 7)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((1024,), 3e38, device="cuda")
    tp, ip = ts.closest_hit_plain(table, o, d, cap)
    occ_p = ts.any_hit_plain(table, o, d, cap)

    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(ts, "closest_hit_plain", refuse)
    monkeypatch.setattr(ts, "any_hit_plain", refuse)
    ts.reset_launch_counts()
    t, idx, ok = ts.mt_intersect_kernel(table, o, d, cap)
    _, _, occ = ts.mt_intersect_kernel(table, o, d, cap, any_hit=True)
    torch.cuda.synchronize()
    assert ts.launch_counts == {"tri_sweep_closest": 1, "tri_sweep_any": 1}
    m = (ip >= 0).cpu()
    assert m.sum() > 50
    np.testing.assert_array_equal(ok.cpu(), m)
    np.testing.assert_array_equal(idx.cpu()[m], ip.cpu()[m])
    np.testing.assert_allclose(t.cpu()[m], tp.cpu()[m], rtol=T_RTOL)
    np.testing.assert_array_equal(occ.cpu(), occ_p.cpu())


@pytest.mark.gpu
def test_wrapper_refuses_malformed_input():
    _card()
    tv, o, d = _random_case(200, 256, 3)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((256,), 3e38, device="cuda")
    with pytest.raises(ValueError):          # rays on two devices
        ts.closest_hit_kernel(table, V3(o.x.cpu(), o.y, o.z), d, cap)
    with pytest.raises(ValueError):          # table on another device
        ts.closest_hit_kernel(ts.pack_sweep_table(tv, "cpu"), o, d, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("where", sorted(COINCIDENT))
def test_coincident_faces_lower_index_on_card(where):
    """Two copies of one triangle, in one block or in two: the kernel
    gives the lower face index, as the plain version does."""
    _card()
    tv, o, d = coincident_case(where)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((o.shape[0],), 3e38, device="cuda")
    t, idx = ts.closest_hit_kernel(table, _on_card(o), _on_card(d), cap)
    tp, ip = ts.closest_hit_plain(table, _on_card(o), _on_card(d), cap)
    lo = min(COINCIDENT[where])
    assert (idx.cpu() == lo).all() and (ip.cpu() == lo).all()
    np.testing.assert_allclose(t.cpu(), tp.cpu(), rtol=T_RTOL)


@pytest.mark.gpu
def test_shadow_rays_match_plain_on_card():
    """Shadow rays as the main path casts them, ~90% of lanes dead."""
    _card()
    tv, o, d, t_max = shadow_case(300, 4096, 5)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.as_tensor(t_max, device="cuda")
    occ = ts.any_hit_kernel(table, _on_card(o), _on_card(d), cap)
    occ_p = ts.any_hit_plain(table, _on_card(o), _on_card(d), cap)
    assert int(occ_p.sum()) > 20
    np.testing.assert_array_equal(occ.cpu(), occ_p.cpu())
    assert not occ.cpu()[t_max < 0].any()


@pytest.mark.gpu
def test_large_mesh_matches_plain_on_card():
    """A mesh of 8,192 + 261 faces (67 blocks, more than one cull window
    and both staging buffers reused many times) and 20,000 rays."""
    _card()
    tv, o, d = _random_case(8192 + 2 * 128 + 5, 20_000, 9)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((20_000,), 3e38, device="cuda")
    t, idx = ts.closest_hit_kernel(table, o, d, cap)
    tp, ip = ts.closest_hit_plain(table, o, d, cap)
    m = (ip >= 0).cpu()
    assert m.sum() > 1000
    np.testing.assert_array_equal((idx >= 0).cpu(), m)
    np.testing.assert_array_equal(idx.cpu()[m], ip.cpu()[m])
    np.testing.assert_allclose(t.cpu()[m], tp.cpu()[m], rtol=T_RTOL)
    half = torch.full((20_000,), 8.0, device="cuda")
    np.testing.assert_array_equal(
        ts.any_hit_kernel(table, o, d, half).cpu(),
        ts.any_hit_plain(table, o, d, half).cpu())


def non_finite_rays(n_rays, seed):
    """Rays of which every fourth has one non-finite origin or direction
    component (inf, -inf or nan, in turn)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bad = np.arange(0, n_rays, 4)
    vals = np.array([np.inf, -np.inf, np.nan], np.float32)
    for i, r in enumerate(bad):
        (o if i % 2 else d)[r, i % 3] = vals[i % 3]
    return o, d, bad


@pytest.mark.gpu
def test_non_finite_rays_miss_on_card():
    """A ray with a non-finite component hits nothing, in both kernels, as
    in the plain version (whose dense dots turn it into NaN)."""
    _card()
    tv = _random_case(300, 1, 4)[0]
    o, d, bad = non_finite_rays(1024, 4)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((1024,), 3e38, device="cuda")
    t, idx = ts.closest_hit_kernel(table, _on_card(o), _on_card(d), cap)
    tp, ip = ts.closest_hit_plain(table, _on_card(o), _on_card(d), cap)
    occ = ts.any_hit_kernel(table, _on_card(o), _on_card(d), cap)
    assert (ip.cpu()[bad] == -1).all() and (idx.cpu()[bad] == -1).all()
    assert not occ.cpu()[bad].any()
    np.testing.assert_array_equal(idx.cpu(), ip.cpu())
    np.testing.assert_array_equal(
        occ.cpu(), ts.any_hit_plain(table, _on_card(o), _on_card(d),
                                    cap).cpu())


@pytest.mark.gpu
def test_chunk_counter_is_zero_after_each_launch():
    """The launch's last claim clears the stream's chunk counter, so
    back-to-back launches of other sizes (here more rays than the grid
    has thread blocks, and fewer) and a launch on another stream all give
    the plain version's results."""
    _card()
    tv, o, d = _random_case(700, 300_000, 11)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((300_000,), 3e38, device="cuda")
    tp, ip = ts.closest_hit_plain(table, o, d, cap)
    side = torch.cuda.Stream()
    for n in (300_000, 1000, 300_000, 37):
        sub = V3(*(c[:n] for c in o)), V3(*(c[:n] for c in d))
        t, idx = ts.closest_hit_kernel(table, *sub, cap[:n])
        np.testing.assert_array_equal(idx.cpu(), ip[:n].cpu())
        occ = ts.any_hit_kernel(table, *sub, cap[:n])
        np.testing.assert_array_equal(occ.cpu(), (ip[:n] >= 0).cpu())
        stream = torch.cuda.current_stream().cuda_stream
        assert ts._COUNTERS[(0, stream)].tolist() == [0]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, idx_side = ts.closest_hit_kernel(table, *sub, cap[:n])
        torch.cuda.current_stream().wait_stream(side)
        np.testing.assert_array_equal(idx_side.cpu(), ip[:n].cpu())
    assert ts._COUNTERS[(0, side.cuda_stream)].tolist() == [0]


@pytest.mark.gpu
def test_step_on_card_matches_cpu():
    """The differentiable step (``bench.step``) at 16x16, 12 iterations,
    on the card and on the CPU: loss and every non-zero gradient channel
    within rel 1e-3 (the kernels sum faces in another order than the plain
    sweep, so a rare lane completes another number of samples)."""
    _card()
    from fountain_tpu_torch import bench
    got = {}
    for dev in ("cuda", "cpu"):
        scene, cam = bench.build_scene(16, dev)
        loss, grad = bench.step(scene, cam, 16, scene.textures.value, 3,
                                n_iters=12)
        got[dev] = (float(loss), grad.cpu())
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    nz = gc != 0
    assert nz.any()
    np.testing.assert_array_equal((gg != 0).numpy(), nz.numpy())
    np.testing.assert_allclose(gg[nz].numpy(), gc[nz].numpy(), rtol=1e-3)


@pytest.mark.gpu
def test_attached_flagship_step_on_card_matches_cpu():
    """The flagship step (``bench.flagship_step``) with attached sampling
    at 16x16 lanes (the file's camera with a 16x16 film), depth 5, on the
    card and on the CPU: loss rel 1e-4; the summed texture-row and texel
    gradients rel 1e-3 and every entry finite; 6 launches of each sweep,
    all in the forward pass, in a step of the card's graphed wave after
    the one that records it (whose one-lane queries, which give the
    static results their dtypes, launch each sweep too)."""
    _card()
    from fountain_tpu_torch import bench
    got = {}
    for dev in ("cuda", "cpu"):
        scene, cam = bench.build_flagship(dev, film_res=16)
        if dev == "cuda":
            bench.flagship_step(scene, cam, 16, 3, detach_sampling=False)
        ts.reset_launch_counts()
        loss, g_tv, g_tx = bench.flagship_step(scene, cam, 16, 3,
                                               detach_sampling=False)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ts.launch_counts == {"tri_sweep_closest": 6,
                                        "tri_sweep_any": 6}
        got[dev] = (float(loss), g_tv.cpu(), g_tx.cpu())
    (lg, tg, xg), (lc, tc, xc) = got["cuda"], got["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for g in (tg, xg):
        assert torch.isfinite(g).all()
    np.testing.assert_allclose(float(tg.sum()), float(tc.sum()), rtol=1e-3)
    np.testing.assert_allclose(float(xg.sum()), float(xc.sum()), rtol=1e-3)


@pytest.mark.gpu
def test_step_launches_sweeps_in_forward_only():
    """One step launches each sweep once per iteration (24), all in the
    forward pass: the backward launches none."""
    _card()
    import dataclasses
    from fountain_tpu_torch import bench
    scene, cam = bench.build_scene(16, "cuda")
    tv = scene.textures.value.clone().requires_grad_(True)
    s = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, value=tv))
    ts.reset_launch_counts()
    loss = bench.loss_of(bench.wave(s, cam, 16, 0))
    fwd = dict(ts.launch_counts)
    loss.backward()
    torch.cuda.synchronize()
    assert fwd == {"tri_sweep_closest": 24, "tri_sweep_any": 24}
    assert ts.launch_counts == fwd
    assert bool((tv.grad != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [["--regen"], ["--samples", "256"]])
def test_cli_furnace_on_card(extra, tmp_path):
    """The render CLI on the card (its default device): the furnace's
    pixels are 2 +- 0.1 at 256 spp of the fixed wave and within
    tests/test_regen.py's gates (mean 2 +- 0.05, pixels 2 +- 0.4) with
    --regen. The furnace has no triangles, so no sweep is launched."""
    _card()
    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.exr import read_exr
    out = str(tmp_path / "furnace.exr")
    ts.reset_launch_counts()
    assert main(["testscenes/furnace_empty.pbrt", "-o", out] + extra) == 0
    img = read_exr(out)
    assert ts.launch_counts == {"tri_sweep_closest": 0, "tri_sweep_any": 0}
    pix, mean = (0.4, 0.05) if "--regen" in extra else (0.1, 0.01)
    assert abs(float(img.mean()) - 2.0) < mean
    np.testing.assert_allclose(img, 2.0, atol=pix)


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
def test_cli_flagship_launches_sweeps_on_card(regen, tmp_path):
    """logo_cube.pbrt through the CLI on the card at 2 spp: both sweeps
    run as CUDA kernels, once a bounce (9 a sample of the fixed wave; once
    an iteration of the regeneration wave), and the image is finite."""
    _card()
    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.exr import read_exr
    out = str(tmp_path / "logo.exr")
    ts.reset_launch_counts()
    assert main(["testscenes/logo_cube.pbrt", "-o", out, "--samples", "2"]
                + (["--regen"] if regen else [])) == 0
    n = 2 + 8 + 1 if regen else 2 * 9
    assert ts.launch_counts == {"tri_sweep_closest": n, "tri_sweep_any": n}
    img = read_exr(out)
    assert img.shape == (256, 256, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "direct", "whitted", "bsdf_only"])
def test_mis_box_modes_on_card_match_cpu(mode):
    """The mis_box (a mesh area light) at 16x16, 2 spp in each integrator
    mode: the card's image equals the CPU's (rtol 1e-3 on every pixel,
    mean rel 1e-4), and a bounce launches the sweeps the mode needs."""
    _card()
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    kw = {"path": {}, "direct": dict(mode="direct"),
          "whitted": dict(mode="whitted"),
          "bsdf_only": dict(nee=False, emit_all_bounces=True)}[mode]
    cfg = PathConfig(max_depth=5, rr_threshold=1.0, **kw)
    imgs = {}
    for dev in ("cuda", "cpu"):
        scene, cam = bench.build_mis_box(dev, 16)
        ts.reset_launch_counts()
        imgs[dev] = render(scene, cam, 16, 16, 2, cfg).cpu()
        if dev == "cuda":
            closest = {"direct": 2}.get(mode, 1) * 6 * 2
            anyhit = {"bsdf_only": 0}.get(mode, 1) * 6 * 2
            assert ts.launch_counts == {"tri_sweep_closest": closest,
                                        "tri_sweep_any": anyhit}
    g, c = imgs["cuda"], imgs["cpu"]
    torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-8)
    assert abs(float(g.mean() - c.mean())) <= 1e-4 * abs(float(c.mean())) \
        or float(c.mean()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("ftype", [1, 2])
def test_filters_and_partial_waves_on_card_match_cpu(ftype):
    """The triangle and Gaussian filters (radius 2) through the aligned
    splat and the scatter splat of two partial waves: card = CPU within
    rtol 1e-5 (the scatter's index_add order differs on the card)."""
    _card()
    from fountain_tpu_torch.scene import film as fm
    rng = np.random.default_rng(ftype)
    w, h = 24, 17
    frac = rng.random((w * h, 2), np.float32)
    rad = rng.random((w * h, 3), np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        v = lambda a: V3(t(a[:, 0]), t(a[:, 1]), t(a[:, 2]))
        full = fm.add_samples_aligned(fm.make_film(w, h, dev), t(frac[:, 0]),
                                      t(frac[:, 1]), v(rad), ftype, 2.0)
        part = fm.make_film(w, h, dev)
        for lo, hi in ((0, 200), (200, w * h)):
            part = fm.add_samples_aligned(
                part, t(frac[lo:hi, 0]), t(frac[lo:hi, 1]), v(rad[lo:hi]),
                ftype, 2.0, lane_offset=lo)
        out[dev] = [fm.finalize(f).cpu() for f in (full, part)]
    for g, c in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_large_mesh_277k_matches_plain_on_card():
    """The 277,248-face mesh of bench.build_large_scene: both kernels
    equal their plain versions on 2,048 random rays, and 10,000 rays from
    the mesh's inside all hit."""
    _card()
    from fountain_tpu_torch import bench
    scene, _, _ = bench.build_large_scene("cuda", 16)
    table = scene.tri_sweep
    assert scene.triangles.count == 277_248 and table.n_blocks == 2166
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform(-25, 25, (2048, 3)), dtype=torch.float32,
                        device="cuda")
    d = rng.normal(size=(2048, 3))
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        dtype=torch.float32, device="cuda")
    ov, dv = V3(*o.unbind(-1)), V3(*d.unbind(-1))
    cap = torch.full((2048,), 3e38, device="cuda")
    t_k, i_k = ts.closest_hit_kernel(table, ov, dv, cap)
    t_p, i_p = ts.closest_hit_plain(table, ov, dv, cap)
    assert torch.equal(i_k >= 0, i_p >= 0) and bool((i_k >= 0).any())
    m = i_k >= 0
    assert torch.equal(i_k[m], i_p[m])
    torch.testing.assert_close(t_k[m], t_p[m], rtol=T_RTOL, atol=0)
    assert torch.equal(ts.any_hit_kernel(table, ov, dv, cap),
                       ts.any_hit_plain(table, ov, dv, cap))
    n = 10_000
    dirs = rng.normal(size=(n, 3))
    dirs = torch.as_tensor(dirs / np.linalg.norm(dirs, axis=-1,
                                                 keepdims=True),
                           dtype=torch.float32, device="cuda")
    zero = torch.zeros(n, device="cuda")
    _, idx = ts.closest_hit_kernel(table, V3(zero, zero, zero),
                                   V3(*dirs.unbind(-1)),
                                   torch.full((n,), 3e38, device="cuda"))
    assert int((idx < 0).sum()) == 0


# The sharded render over two ranks of ``shard.run_ranks``, started in a
# child Python (whose spawned ranks import this JAX-free module):
# tests/test_torch_shard.py runs it on the CPU, the test below on the card.
SHARD_CFG = dict(max_depth=3, rr_threshold=0.0, nee=True)


def furnace_image_and_grad(device, res, spp, sharded):
    """(image, d mean(image) / d textures.value) of the furnace (config 1,
    bench's camera) at res x res, spp samples; sharded over the ranks of
    the process group (the gradient summed with ``all_reduce_grads``) or
    ``render`` in this process."""
    import dataclasses

    from fountain_tpu_torch import bench
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.parallel import shard
    scene, cam = bench.build_furnace(device, res)
    tv = scene.textures.value.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, value=tv))
    fn = shard.render_sharded if sharded else render
    img = fn(scene, cam, res, res, spp, PathConfig(**SHARD_CFG))
    img.mean().backward()
    if sharded:
        shard.all_reduce_grads([tv])
    return img.detach().cpu(), tv.grad.cpu()


def furnace_rank(rank, device, res, spp, out):
    """One rank: saves its image and summed gradient to ``out.<rank>``."""
    torch.set_num_threads(1)
    img, grad = furnace_image_and_grad(device, res, spp, sharded=True)
    torch.save({"img": img, "grad": grad}, f"{out}.{rank}")


def run_furnace_ranks(devices, res, spp, tmp_path, backend=None):
    """``furnace_rank`` on one rank per entry of ``devices``, in a child
    Python (temporary files, the rendezvous store among them, under
    ``tmp_path``); returns each rank's {"img", "grad"}."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "rank")
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "from test_torch_gpu import furnace_rank; "
            "from fountain_tpu_torch.parallel.shard import run_ranks; "
            f"run_ranks(furnace_rank, {list(devices)!r}, "
            f"args=({res}, {spp}, sys.argv[1]), backend={backend!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code, out], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return [torch.load(f"{out}.{r}") for r in range(len(devices))]


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_render(tmp_path):
    """Two gloo ranks on cuda:0 render the 64 x 64 furnace (16 spp): each
    rank's image equals the one-process render on the card (rtol 1e-6),
    and the summed gradient of its mean the one-process gradient (rtol
    1e-5)."""
    _card()
    ranks = run_furnace_ranks(["cuda:0", "cuda:0"], 64, 16, tmp_path,
                              backend="gloo")
    img, grad = furnace_image_and_grad("cuda", 64, 16, sharded=False)
    for got in ranks:
        torch.testing.assert_close(got["img"], img, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["grad"], grad, rtol=1e-5, atol=1e-7)


def _walk_scene(tv, device):
    """A one-mesh scene of the faces ``tv`` [F, 3, 3] with its BVH tables
    (``attach_bvh``)."""
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.scene.build import SceneBuilder
    b = SceneBuilder()
    mat = b.add_matte()
    b.add_triangle_mesh(tv.reshape(-1, 3),
                        np.arange(3 * len(tv), dtype=np.int32).reshape(-1, 3),
                        mat_id=mat)
    return attach_bvh(b.build(device=device))


def _walk_cases():
    """(label, scene on the card, o, d, t_max) of both walk tests: random
    faces and rays (with dead lanes and a finite limit) and the rounded
    cube from outside and from its interior."""
    from fountain_tpu_torch.bench import build_scene
    tv, o, d = _random_case(5000, 4096, 21)
    t_max = torch.full((4096,), float("inf"), device="cuda")
    t_max[::5] = -1.0
    t_max[1::5] = 6.0
    yield "random", _walk_scene(tv, "cuda"), o, d, t_max
    cube = build_scene(16, "cuda")[0]
    rng = np.random.default_rng(3)
    o = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    yield "cube", cube, _on_card(o), _on_card(d), torch.full(
        (4096,), 3e38, device="cuda")
    zero = np.zeros((4096, 3), np.float32)
    yield "cube_interior", cube, _on_card(zero), _on_card(d), torch.full(
        (4096,), float("inf"), device="cuda")


@pytest.mark.gpu
def test_walk_kernels_match_plain_on_card(monkeypatch):
    """Both walk kernels equal their plain versions (found and idx equal,
    t within rtol 1e-6, any hit equal; the interior rays all hit), count
    their launches, and a CUDA tensor never reaches the plain walk."""
    _card()
    from fountain_tpu_torch.geometry import bvh_walk as bw
    for label, scene, o, d, t_max in _walk_cases():
        args = (scene.bvh_nodes8, scene.bvh_tri_verts, o, d, t_max)
        tp, ip = bw.closest_hit_plain(*args)
        occ_p = bw.any_hit_plain(*args)
        with monkeypatch.context() as mp:
            def refuse(*a, **k):
                raise AssertionError("plain walk called on CUDA tensors")
            mp.setattr(bw, "closest_hit_plain", refuse)
            mp.setattr(bw, "any_hit_plain", refuse)
            bw.reset_launch_counts()
            t, idx, ok = bw.walk_intersect(*args)
            occ = bw.walk_intersect(*args, any_hit=True)[2]
            torch.cuda.synchronize()
        assert bw.launch_counts == {"bvh_walk_closest": 1,
                                    "bvh_walk_any": 1}, label
        m = (ip >= 0).cpu()
        assert m.sum() > 100, label
        np.testing.assert_array_equal(ok.cpu(), m, err_msg=label)
        np.testing.assert_array_equal(idx.cpu()[m], ip.cpu()[m],
                                      err_msg=label)
        np.testing.assert_allclose(t.cpu()[m], tp.cpu()[m], rtol=1e-6,
                                   err_msg=label)
        np.testing.assert_array_equal(occ.cpu(), occ_p.cpu(), err_msg=label)
        if label == "cube_interior":
            assert bool(ok.all()) and bool(occ.all())


@pytest.mark.gpu
def test_walk_refuses_malformed_input():
    _card()
    from fountain_tpu_torch.geometry import bvh_walk as bw
    tv, o, d = _random_case(200, 256, 3)
    scene = _walk_scene(tv, "cuda")
    cap = torch.full((256,), 3e38, device="cuda")
    with pytest.raises(ValueError):          # rays on two devices
        bw.closest_hit_kernel(scene.bvh_nodes8, scene.bvh_tri_verts,
                              V3(o.x.cpu(), o.y, o.z), d, cap)
    with pytest.raises(ValueError):          # tables on the CPU
        bw.any_hit_kernel(scene.bvh_nodes8.cpu(), scene.bvh_tri_verts, o, d,
                          cap)
    with pytest.raises(ValueError):          # a node table of 7 columns
        bw.closest_hit_kernel(scene.bvh_nodes8[:, :7].contiguous(),
                              scene.bvh_tri_verts, o, d, cap)
