"""Share of the traced stretch's admissions whose final prefill chunk
was served by a replay of its CUDA graph, not by eager launches: the
engine's `prefill_replays` over its `admitted`, in percent.  The
model-step layer; moves out_tok_s.  A program without the counter
gives no reading."""


def read(obs):
    c = obs["counters"]
    if "prefill_replays" not in c or not c.get("admitted"):
        return None
    return 100.0 * c["prefill_replays"] / c["admitted"]
