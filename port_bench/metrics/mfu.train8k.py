"""Model FLOPs of the training steps in the traced stretch (3 x the
forward: every layer's projections, causal MLA at its true widths, the
head over the vocabulary slice, and each route to a held expert counted
from the model's `moe_held_routes`) over the card's bf16 peak, in
percent (reference/counts_moonlight.py).  The model-step layer; moves
train_step_ms.  None without the expert counters."""

from port_bench.reference import counts, counts_moonlight


def read(obs):
    c = obs.get("counters")
    if not c or "moe_held_routes" not in c:
        return None
    flops = counts_moonlight.train_flops(
        obs["model"], obs["steps"], obs["batch"], obs["seq_len"],
        c["moe_held_routes"])
    return counts.share(flops, counts.PEAK_BF16_FLOPS, obs["window_s"])
