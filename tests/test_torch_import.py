"""The port imports neither JAX nor the JAX package, nor Pillow.

Checked twice: a grep of every import statement in fountain_tpu_torch/ and
chip_smoke.py, and an import of every module of the package in a fresh
interpreter whose sys.modules must then hold no ``jax``, no
``fountain_tpu`` and no ``PIL`` (the port decodes and encodes its PNG
and JPEG images itself, so it needs no Pillow where it runs).
"""
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (the test files of the port import both)
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
_BAD = re.compile(
    r"^\s*(import|from)\s+(jax|fountain_tpu|PIL|Pillow)(\.|\s|$)",
    re.MULTILINE)


def test_no_jax_import_statements():
    files = sorted((ROOT / "fountain_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _BAD.finditer(f.read_text())]
    assert not bad, bad


def test_import_leaves_no_jax_in_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fountain_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'fountain_tpu' or "
        "k.startswith('fountain_tpu.') or k.split('.')[0] in "
        "('PIL', 'Pillow')]\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('fountain_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 20


def test_walk_modules_build_nothing_at_import():
    """The BVH modules and the gathers' module import without building
    anything: nvcc and g++ run at first use only (the wrappers'
    ``_library``), and the walk's kernels and counts are named as
    chip_smoke.py reports them."""
    code = (
        "import fountain_tpu_torch.native as n\n"
        "import fountain_tpu_torch.geometry.bvh_walk as bw\n"
        "import fountain_tpu_torch.geometry.tri_sweep as ts\n"
        "import fountain_tpu_torch.core.gather as g\n"
        "assert n._LIB is None and bw._LIB is None and ts._LIB is None\n"
        "assert g._LIB is None\n"
        "assert bw.KERNELS == ('bvh_walk_closest', 'bvh_walk_any')\n"
        "assert set(ts.SOURCES) == {'tri_sweep', 'bvh_walk', "
        "'scatter_rows'}\n"
        "assert '-fmad=false' in ts.SOURCES['bvh_walk']\n"
        "assert not ts.build_logs\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for src in ("bvh_walk.cu", "lbvh.cc", "scatter_rows.cu"):
        assert (ROOT / "fountain_tpu_torch" / "csrc" / src).is_file()
