"""Port parity: NEE off (BSDF sampling only) and the CLI's ``bsdf``
integrator.

The gates of tests/test_torch_modes.py (``check_wave``) for the wave
without NEE and with emission at every bounce, on the scene with every
light type but the sphere's. ``Integrator "bsdf"`` of a pbrt file maps as
the JAX CLI maps it: nee=False with emit_all_bounces left False, so
emission counts on camera and specular bounces only and the furnace
renders 1, not its analytic 2 (a fault of the reference that the port
keeps; ROADMAP C.3).

Regeneration waves in the direct and whitted modes are not compared with
the JAX package's: JAX's regeneration wave compiles for ~60 s on the CPU
(~170 s on one core). The refill logic is the same in every mode; it is
held to JAX's in path mode by tests/test_torch_path.py, and in each mode
a regeneration wave that refills no lane equals the fixed wave bitwise
(tests/test_torch_modes.py).
"""
import numpy as np
import pytest
import torch

from tests.test_torch_lights import _all_lights_scene
from tests.test_torch_modes import check_wave


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_nee_off_wave_matches_jax():
    """BSDF sampling only: nee=False, emission at every bounce."""
    check_wave(_all_lights_scene(), "path", False, True, False)


def test_cli_bsdf_integrator_as_jax(tmp_path):
    """Both CLIs render the furnace with ``Integrator "bsdf"`` to the
    same image: its emission at the camera bounce only, 1.0 in every
    pixel."""
    import pathlib
    from fountain_tpu.cli.render import main as jmain
    from fountain_tpu.io.exr import read_exr as jread
    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.exr import read_exr
    text = pathlib.Path("testscenes/furnace_empty.pbrt").read_text()
    path = tmp_path / "bsdf.pbrt"
    path.write_text(text.replace('Integrator "path"', 'Integrator "bsdf"'))
    assert main([str(path), "--cpu", "--samples", "2", "-o",
                 str(tmp_path / "t.exr")]) == 0
    assert jmain([str(path), "--cpu", "--samples", "2", "-o",
                  str(tmp_path / "j.exr")]) == 0
    t, j = read_exr(str(tmp_path / "t.exr")), jread(str(tmp_path / "j.exr"))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, 1.0, rtol=1e-6)
