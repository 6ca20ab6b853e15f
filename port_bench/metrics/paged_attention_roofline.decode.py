"""The paged attention kernel's share of its bytes bound, in percent:
the K and V rows that the generated tokens of the traced stretch needed
(each token's visible context, every layer) plus their q and output, at
the card's HBM rate, over the kernel's device time in the trace
(reference/counts.py).  The kernels layer; moves out_tok_s."""

from port_bench.reference import counts


def read(obs):
    t = sum(s for _, s in obs["trace"].kernels("paged_attention"))
    need = sum(counts.paged_attn_bytes(obs["model"], c)
               for c in obs["decode_ctx"])
    return counts.share(need, counts.HBM_BYTES_PER_S, t)
