"""Model FLOPs of the training steps in the traced stretch (3 x the
forward: every layer, causal attention and the head on every row) over
the card's bf16 peak, in percent (reference/counts.py).  The model-step
layer; moves train_step_ms."""

from port_bench.reference import counts


def read(obs):
    flops = obs["steps"] * counts.train_step_flops(
        obs["model"], obs["batch"], obs["seq_len"])
    return counts.share(flops, counts.PEAK_BF16_FLOPS, obs["window_s"])
