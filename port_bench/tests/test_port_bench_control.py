"""The lower-precision control at a size a test run holds: the fp8
reference in the program's place reads wider gaps than the program.
At the cells' own sizes on the card it is `python3 -m
port_bench.calibrate control` (PERF.md gives its readings), and
test_port_bench_card.py holds one seed of it against the limits."""

import pytest

from port_bench import run
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_serving_control_reads_wider_than_the_program(bench, seed):
    out, _ = run.run_cell(bench, "gpt2xl.decode", seed, 1.0, 0,
                          device="cpu", control=True)
    r = out.readings
    assert r["requests"] > 0 and r["control_gap"] > r["gap"]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_training_control_reads_wider_than_the_program(bench, seed):
    out, _ = run.run_cell(bench, "gpt2m.train", seed, 0.5, 0, device="cpu",
                          control=True)
    prog, ctrl = out.readings["program"], out.readings["control"]
    assert ctrl["grad"] > prog["grad"] and ctrl["loss"] > prog["loss"]
    half = out.readings["half_batch"]
    assert half["grad"] > 10 * prog["grad"]
