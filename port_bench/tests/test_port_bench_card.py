"""Runs on the card (marker `card`): one cell for a few seconds through
the command the benchmark's checks run, and one seed of the control at
the cell's own size against its limit.  Each skips without a card,
decided inside the test."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on an NVIDIA card")


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    _need_card()
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "gpt2xl.decode", "--seed", "2147483701", "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["out_tok_s"]["value"] > 0


@pytest.mark.card
def test_control_fails_at_the_cells_size():
    _need_card()
    from port_bench import run, spec

    out, line = run.run_cell(spec.Bench(), "gpt2xl.decode", 2147483702, 8,
                             0, control=True)
    assert line["correct"]
    assert out.readings["control_gap"] > line["checks"]["gap"]["limit"]
