"""Nothing the benchmark runs loads JAX, flax or the JAX package
(top-level module names compared whole), and the reference loads
nothing of the program."""

import os
import subprocess
import sys

from port_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _python(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_whole_names_are_compared():
    assert run.forbidden_modules(
        ["container_engine_accelerators_tpu_torch.models", "numpy"]) == []
    assert run.forbidden_modules(
        ["jax.numpy", "flax", "container_engine_accelerators_tpu.ops",
         "jaxlib"]) == ["container_engine_accelerators_tpu", "flax", "jax",
                        "jaxlib"]


def test_runs_load_no_jax():
    code = (
        "import tempfile\n"
        "from port_bench import run\n"
        "from port_bench.tests import tiny\n"
        "b = tiny.write(tempfile.mkdtemp())\n"
        "for cell in ('gpt2xl.decode', 'gpt2m.train', 'gpt2xl.chat'):\n"
        "    run.run_cell(b, cell, 3, 0.5, 1, device='cpu')\n"
        "print(run.forbidden_modules())\n")
    assert _python(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "from port_bench.reference import gpt2, compare, counts\n"
        "from port_bench import weights, traffic, stats, trace\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'container_engine_accelerators_tpu_torch', 'jax', 'flax',\n"
        "         'container_engine_accelerators_tpu'}))\n")
    assert _python(code) == "[]"
