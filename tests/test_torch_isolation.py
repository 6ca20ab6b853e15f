"""The port imports neither JAX nor the JAX package: importing every
module of container_engine_accelerators_tpu_torch (in a fresh
interpreter) leaves `jax` and `container_engine_accelerators_tpu` out of
sys.modules, and no port file (nor chip_smoke.py) names either in an
import statement."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import container_engine_accelerators_tpu_torch as PORT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(PORT.__file__)
_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|flax|container_engine_accelerators_tpu)\b",
    re.MULTILINE,
)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            [PKG_DIR], prefix=PORT.__name__ + "."
        )
    )


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 31, mods
    assert {f"{PORT.__name__}.{m}" for m in (
        "ops.chunked_xent", "models.inception", "utils.checkpoint",
        "server")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'flax' or "
        "k.split('.')[0] == 'container_engine_accelerators_tpu')\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
))
def test_no_port_file_imports_jax(path):
    with open(path) as f:
        src = f.read()
    assert not _IMPORT.search(src), path
