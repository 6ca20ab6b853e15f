"""The port imports neither JAX nor the JAX package: importing every
module of container_engine_accelerators_tpu_torch (in a fresh
interpreter) leaves `jax` and `container_engine_accelerators_tpu` out of
sys.modules, no port file (nor chip_smoke.py) names either in an
import statement, and none names a module of the JAX package in a
string (a `-m` target or a factory spec would run the reference in a
spawned process).  A spawned port worker's own sys.modules is held in
tests/test_torch_worker_rpc.py."""

import json
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
# The JAX package followed by a module path inside a string literal.
_MODULE_STRING = re.compile(
    r"""["']container_engine_accelerators_tpu\.[A-Za-z_]""")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            [PKG_DIR], prefix=PORT.__name__ + "."
        )
    )


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 36, mods
    assert {f"{PORT.__name__}.{m}" for m in (
        "ops.chunked_xent", "models.inception", "utils.checkpoint",
        "server", "serving.router", "serving.faults", "serving.fleet",
        "serving.rpc", "serving.worker")} <= set(mods)
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


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
))
def test_no_port_file_names_a_jax_package_module(path):
    with open(path) as f:
        src = f.read()
    assert not _MODULE_STRING.search(src), path


def test_a_spawned_worker_runs_the_port_and_imports_no_jax(tmp_path):
    # The worker's factory (loaded by file path) writes the worker
    # interpreter's jax / JAX-package modules before it builds the model.
    from container_engine_accelerators_tpu_torch.serving.fleet import (
        ProcessFleetManager,
    )

    out = str(tmp_path / "modules.json")
    factory = os.path.join(ROOT, "tests", "torch_worker_factories.py")
    fleet = ProcessFleetManager(
        f"{factory}:modules_probe_factory", dict(out=out, device="cpu"),
        1, 2, spawn_timeout_s=120.0, worker_env={"OMP_NUM_THREADS": "1"})
    try:
        assert fleet.engines[0]._argv()[1:3] == [
            "-m", f"{PORT.__name__}.serving.worker"]
        with open(out) as f:
            assert json.load(f) == []
        assert len(fleet.submit([[1, 2, 3]], 3, 0.0, timeout=120)[0]) == 3
    finally:
        fleet.close()
