"""Model FLOPs of the tokens served in the traced stretch over the
card's bf16 peak, in percent (reference/counts.py): each generated token
after the first at its context, each admission's prompt positions that
ran (a shared prefix is taken as served from the cache) with the head
on its last row.  The model-step layer; moves out_tok_s."""

from port_bench.reference import counts


def read(obs):
    m = obs["model"]
    flops = sum(counts.decode_token_flops(m, c) for c in obs["decode_ctx"])
    flops += sum(counts.prefill_flops(m, s, e) for s, e in obs["prefills"])
    return counts.share(flops, counts.PEAK_BF16_FLOPS, obs["window_s"])
