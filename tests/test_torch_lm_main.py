"""The port's training job (python -m container_engine_accelerators_tpu_
torch.lm_main) end to end in a subprocess at a tiny size on the CPU: it
exits 0 and logs the reference's loss lines; with --model-dir a second
run resumes from the first one's checkpoint and saves its own past it;
an unported mode exits 2 naming its ROADMAP item; and without --device
cpu, on a machine with no card, it exits non-zero saying so."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "--seq-len", "128", "--batch", "2", "--dim", "32", "--depth", "1",
    "--vocab", "64", "--heads", "2", "--train-steps", "3",
    "--log-every", "1",
]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch."
         "lm_main", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


@pytest.mark.parametrize("attn", ["auto", "flash"])
def test_tiny_cpu_run_logs_loss_lines(attn):
    out = _run(*TINY, "--attn-impl", attn, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    steps = re.findall(
        r"step (\d+) loss ([0-9.]+) tokens/sec \d+ \(\d+/chip\)", out.stderr
    )
    assert [int(s) for s, _ in steps] == [1, 2, 3], out.stderr
    losses = [float(v) for _, v in steps]
    assert all(0 < v < 10 for v in losses), losses
    assert "done: 3 steps" in out.stderr


def test_heads_flag_at_head_dim_64_trains_on_the_cpu():
    # dim 128 at 2 heads: head dim 64, one of the two the card's flash
    # kernels are built for (the other, 128, is --heads 0's default).
    out = _run("--seq-len", "128", "--batch", "2", "--dim", "128",
               "--depth", "1", "--vocab", "64", "--heads", "2",
               "--train-steps", "2", "--log-every", "1", "--attn-impl",
               "flash", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    losses = [float(v) for v in re.findall(r"step \d+ loss ([0-9.]+)",
                                           out.stderr)]
    assert len(losses) == 2 and all(0 < v < 10 for v in losses), out.stderr
    assert "done: 2 steps" in out.stderr


def test_model_dir_resumes_from_its_own_checkpoint(tmp_path):
    # A run of N steps trains the warm-up step too: N + 1 steps a run.
    first = _run(*TINY, "--device", "cpu", "--model-dir", str(tmp_path))
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stderr
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4"]
    second = _run(*TINY, "--device", "cpu", "--model-dir", str(tmp_path))
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stderr
    steps = re.findall(r"step (\d+) loss", second.stderr)
    assert [int(s) for s in steps] == [1, 2, 3], second.stderr
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4", "checkpoint_8"]


@pytest.mark.parametrize("flags,item", [
    (["--mode", "tp"], "A10"),
    (["--seq-parallel"], "A10"),
])
def test_unported_options_exit_2(flags, item):
    out = _run(*TINY, "--device", "cpu", *flags)
    assert out.returncode == 2, out.stderr
    assert item in out.stderr


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    out = _run(*TINY)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
