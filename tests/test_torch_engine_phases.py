"""The continuous engine's scheduler-phase counters
(container_engine_accelerators_tpu_torch/serving/engine.py, _PhaseClock):
present from the start and never decreasing, an `on_token` callback's
time and a side job's time counted in the phase and the starved share
they belong to, the phases within the scheduler thread's wall time, and
the `engine.*` profiler ranges, made only while a profiler runs.  CPU,
tiny model; the bounds are loose, as the tier runs six workers at once.

Everything up to the scheduler's last admission is folded into `stats`,
so each test submits one more one-token request (`_flush`) before it
reads the counters of what went before."""

import threading
import time

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from _torch_port import PAGE, draw_params, port_model, rand_prompt
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
)
from container_engine_accelerators_tpu_torch.serving import engine as engine_mod

# The phases that partition the scheduler thread's time.
PARTITION = ("phase_wait_ns", "phase_side_ns", "phase_admit_ns",
             "phase_stage_ns", "phase_dispatch_ns", "phase_sync_ns",
             "phase_commit_ns")
KEYS = PARTITION + ("starved_ns", "starved_admit_ns", "starved_commit_ns",
                    "launch_idle_ns")
RANGES = {"engine.admit", "engine.stage", "engine.dispatch", "engine.sync",
          "engine.commit"}
MODES = {"one_token": {}, "fused": {"decode_steps": 4},
         "spec": {"spec_k": 2}}


@pytest.fixture(scope="module")
def pm():
    return port_model(draw_params(0))


def _engine(pm, mode="one_token"):
    return ContinuousBatchingEngine(
        pm, 2, device="cpu", prompt_grid=4, prefill_chunk=PAGE,
        page_size=PAGE, **MODES[mode])


def _flush(eng, seed=99):
    """One more request: its admission folds all that went before."""
    eng.submit(rand_prompt(seed, PAGE + 1), 1, 0.0, timeout=300)


def _delta(a, b, key):
    return b[key] - a[key]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_counters_start_at_zero_and_never_decrease(pm, mode):
    eng = _engine(pm, mode)
    try:
        fresh = eng.snapshot()
        for k in KEYS:
            assert type(fresh[k]) is int, k
            # Only the scheduler's first wait can have been counted.
            assert fresh[k] == 0 or k == "phase_wait_ns", (k, fresh[k])
        snaps, done = [fresh], threading.Event()

        def poll():
            while not done.is_set():
                snaps.append(eng.snapshot())
                time.sleep(0.002)

        poller = threading.Thread(target=poll)
        poller.start()
        try:
            eng.submit(rand_prompt(1, 2 * PAGE + 3), 6, 0.0, timeout=300)
            eng.submit(rand_prompt(2, 5), 4, 0.0, timeout=300)
            _flush(eng)
        finally:
            done.set()
            poller.join()
        snaps.append(eng.snapshot())
        for a, b in zip(snaps, snaps[1:]):
            for k in KEYS:
                assert type(b[k]) is int and b[k] >= a[k], k
        last = snaps[-1]
        for k in ("phase_admit_ns", "phase_stage_ns", "phase_dispatch_ns",
                  "phase_sync_ns", "phase_commit_ns", "starved_ns",
                  "launch_idle_ns"):
            assert last[k] > 0, k
    finally:
        eng.close()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_on_token_time_is_starved_commit_time(pm, mode):
    # A callback runs after the readback that drained the device: its
    # time is commit time in which nothing was outstanding.
    nap, n = 0.02, 8
    eng = _engine(pm, mode)
    try:
        _flush(eng, seed=3)
        a = eng.snapshot()
        eng.submit(rand_prompt(4, PAGE + 2), n, 0.0, timeout=300,
                   on_token=lambda row, tok: time.sleep(nap))
        _flush(eng)
        b = eng.snapshot()
    finally:
        eng.close()
    slept = nap * n * 1e9
    assert _delta(a, b, "starved_commit_ns") >= 0.8 * slept
    assert _delta(a, b, "phase_commit_ns") >= _delta(a, b,
                                                     "starved_commit_ns")
    assert _delta(a, b, "starved_ns") >= _delta(a, b, "starved_commit_ns")


def test_side_job_time_is_side_and_starved_but_not_commit(pm):
    nap = 0.2
    eng = _engine(pm)
    try:
        _flush(eng, seed=5)
        a = eng.snapshot()
        eng._side_call(lambda: time.sleep(nap), 60)
        _flush(eng)
        b = eng.snapshot()
    finally:
        eng.close()
    side = _delta(a, b, "phase_side_ns")
    rest = (_delta(a, b, "starved_ns") - _delta(a, b, "starved_admit_ns")
            - _delta(a, b, "starved_commit_ns"))
    assert side >= 0.8 * nap * 1e9
    assert rest >= side
    assert _delta(a, b, "phase_commit_ns") < 0.25 * nap * 1e9
    assert _delta(a, b, "starved_commit_ns") < 0.25 * nap * 1e9


@pytest.mark.parametrize("mode", sorted(MODES))
def test_phases_sum_within_the_threads_wall_time(pm, mode):
    t_start = time.monotonic()
    eng = _engine(pm, mode)
    try:
        a = eng.snapshot()
        t0 = time.monotonic()
        eng.submit(rand_prompt(6, 2 * PAGE), 8, 0.0, timeout=300)
        t1 = time.monotonic()
        _flush(eng)
        b = eng.snapshot()
        t_b = time.monotonic()
    finally:
        eng.close()
    total = sum(_delta(a, b, k) for k in PARTITION)
    assert total <= (t_b - t_start) * 1e9
    # The thread worked through the whole request, all of it folded.
    assert total >= 0.5 * (t1 - t0) * 1e9
    assert (b["starved_admit_ns"] + b["starved_commit_ns"]
            <= b["starved_ns"] <= sum(b[k] for k in PARTITION))
    assert b["launch_idle_ns"] <= b["phase_admit_ns"] + b[
        "phase_dispatch_ns"] + b["phase_side_ns"]


def test_profiler_ranges_name_the_phases(pm):
    # The scheduler is a thread of its own, so the profiler records
    # every thread.
    eng = _engine(pm, "fused")
    try:
        _flush(eng, seed=7)
        t0 = time.monotonic()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True)) as prof:
            eng.submit(rand_prompt(8, 2 * PAGE + 1), 6, 0.0, timeout=300)
        window_us = (time.monotonic() - t0) * 1e6
        _flush(eng)
    finally:
        eng.close()
    ranges = [e for e in prof.events() if e.name.startswith("engine.")]
    assert {e.name for e in ranges} == RANGES
    for e in ranges:
        assert 0 <= e.time_range.start <= e.time_range.end <= window_us


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_range_is_made_without_a_profiler(pm, mode, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range without a profiler")

    monkeypatch.setattr(engine_mod, "_RecordFunctionFast", refuse)
    eng = _engine(pm, mode)
    try:
        out = eng.submit(rand_prompt(9, 2 * PAGE), 6, 0.0, timeout=300)
        _flush(eng)
        assert len(out[0]) == 6 and not eng.crashed
    finally:
        eng.close()
