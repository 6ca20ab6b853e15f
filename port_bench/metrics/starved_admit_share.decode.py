"""The part of starved_share.decode the host spent in admission turns
(the prefix lookup, page allocation, bookkeeping around the prefill
calls): the engine's `starved_admit_ns` over the stretch, in percent.
The engine layer; moves out_tok_s."""

KEY = "starved_admit_ns"

# The scheduler phases that partition the thread's time: their sum is
# the stretch the counters cover, which is folded at the engine's
# commits and so ends a little before or, where a stall of the
# profiler's stop was folded before the reading, well after the
# window.  The share is of the longer of the two: of the window, as
# idle_share.decode is, unless the counters cover more than it.
PHASES = ("phase_wait_ns", "phase_side_ns", "phase_admit_ns",
          "phase_stage_ns", "phase_dispatch_ns", "phase_sync_ns",
          "phase_commit_ns")


def read(obs):
    c = obs["counters"]
    if KEY not in c:
        return None
    total = max(sum(c.get(k, 0) for k in PHASES), obs["window_s"] * 1e9)
    return 100.0 * c[KEY] / total if total else None
