"""The port's training job (python -m container_engine_accelerators_tpu_
torch.lm_main) end to end in a subprocess at a tiny size on the CPU: it
exits 0 and logs the reference's loss lines; with --model-dir a second
run resumes from the first one's checkpoint and saves its own past it;
every mode trains on two CPU ranks (--ranks 2), all from the same
seeded weights, so dp, sp (both layouts), tp and pp log the same first
loss; under --distributed across two hosts (two processes here) each
host starts one rank per local device (--ranks 2), ranks host * 2 +
local of 4; the reference's refusals exit 2 with its messages; a checkpoint
written at two ranks restores at one (dp here; ep, whose experts the
two ranks split, in tests/test_torch_moe_lm.py); --seq-parallel on one
rank degrades to dp with the reference's warning; and without --device
cpu, on a machine with no card, it exits non-zero saying so.  Runs that
spawn no rank (the refusals, the one-rank runs) call main in this
process."""

import logging
import os
import re
import socket
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


def _first_loss(text):
    return float(re.findall(r"step 1 loss ([0-9.]+)", text)[0])


def _main(caplog, *args):
    """lm_main.main in this process (a run that spawns no rank, or
    refuses before it would): (exit code, its log text)."""
    from container_engine_accelerators_tpu_torch import lm_main

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="lm_main"):
        rc = lm_main.main(list(args))
    return rc, caplog.text


MODES = [
    ["--mode", "dp"],
    ["--mode", "sp"],
    ["--mode", "sp", "--seq-layout", "zigzag"],
    ["--mode", "tp"],
    ["--mode", "pp", "--micro", "4", "--batch", "4"],
    ["--mode", "ep"],
]


@pytest.mark.parametrize("flags", MODES, ids=lambda f: "-".join(f[1::2]))
def test_modes_train_on_two_cpu_ranks(flags, caplog):
    out = _run(*TINY, "--depth", "2", "--device", "cpu", "--ranks", "2",
               *flags)
    assert out.returncode == 0, out.stderr
    steps = re.findall(r"step (\d+) loss ([0-9.]+) tokens/sec \d+ "
                       r"\((\d+)/chip\)", out.stderr)
    assert [int(s) for s, _, _ in steps] == [1, 2, 3], out.stderr
    assert "done: 3 steps" in out.stderr
    if flags[1] != "ep":
        # Every dense mode trains the one-rank trainer's seeded weights.
        batch = flags[flags.index("--batch"):][:2] if "--batch" in flags else []
        rc, single = _main(caplog, *TINY, "--depth", "2", "--device", "cpu",
                           *batch)
        assert rc == 0
        assert _first_loss(out.stderr) == pytest.approx(
            _first_loss(single), abs=2e-3)


# One host's process of a two-host job: lm_main's coordinator is the
# first hostname at distributed.cluster_from_env's port, here a free one.
HOST = """
import sys
from container_engine_accelerators_tpu_torch import lm_main
from container_engine_accelerators_tpu_torch.parallel import distributed
real = distributed.cluster_from_env
distributed.cluster_from_env = lambda env: real(env, int(sys.argv[1]))
sys.exit(lm_main.main(sys.argv[2:]))
"""


def test_distributed_starts_one_rank_per_local_device(caplog):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = [*TINY, "--batch", "4", "--device", "cpu", "--ranks", "2",
             "--distributed"]
    hosts = [subprocess.Popen(
        [sys.executable, "-c", HOST, str(port), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                 TPU_WORKER_ID=str(h)))
        for h in range(2)]
    try:
        errs = [h.communicate(timeout=240)[1] for h in hosts]
    finally:
        for h in hosts:
            h.kill()
    assert [h.returncode for h in hosts] == [0, 0], errs
    assert "data parallel over 4 chips" in errs[0], errs[0]
    assert "done: 3 steps" in errs[0], errs[0]
    # The four ranks train the one-rank trainer's seeded weights on
    # their shares of one global batch.
    rc, single = _main(caplog, *TINY, "--batch", "4", "--device", "cpu")
    assert rc == 0
    assert _first_loss(errs[0]) == pytest.approx(_first_loss(single),
                                                 abs=2e-3)


@pytest.mark.parametrize("flags,message", [
    (["--mode", "tp"], "--mode tp needs >1 chip (1 visible)"),
    (["--mode", "ep"], "--mode ep needs >1 chip (1 visible)"),
    (["--seq-layout", "zigzag"], "--seq-layout zigzag needs --mode sp"),
    (["--seq-parallel", "--mode", "tp"], "conflicts with --mode tp"),
    (["--mode", "tp", "--ranks", "2", "--heads", "3"],
     "tp: --heads 3 does not divide over 2 chips"),
    (["--mode", "tp", "--ranks", "3", "--dim", "32", "--heads", "0"],
     "tp: no head count divides both dim 32 and 3 chips"),
    (["--mode", "pp", "--ranks", "2", "--depth", "3"],
     "pp: depth 3 must split evenly over 2 stages x 1 virtual chunks"),
    (["--mode", "ep", "--ranks", "2", "--experts", "3"],
     "ep: --experts 3 must divide over 2 chips"),
])
def test_refusals_exit_2(flags, message, caplog):
    rc, text = _main(caplog, *TINY, "--device", "cpu", *flags)
    assert rc == 2, text
    assert message in text


def test_seq_parallel_on_one_rank_degrades_to_dp(caplog):
    rc, text = _main(caplog, *TINY, "--device", "cpu", "--seq-parallel")
    assert rc == 0, text
    assert "--seq-parallel with 1 visible chip: training single-chip" in text
    assert "done: 3 steps" in text


def test_checkpoint_from_two_ranks_restores_on_one(tmp_path, caplog):
    first = _run(*TINY, "--device", "cpu", "--model-dir", str(tmp_path),
                 "--ranks", "2")
    assert first.returncode == 0, first.stderr
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4"]
    rc, text = _main(caplog, *TINY, "--device", "cpu", "--model-dir",
                     str(tmp_path))
    assert rc == 0, text
    assert "resumed from step 4" in text
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4", "checkpoint_8"]


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    out = _run(*TINY)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
