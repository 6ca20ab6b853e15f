"""The flash attention kernels' share of their operations bound, in
percent: the causal operations of each forward launch (flash_fwd) and
each backward (one flash_bwd_dq a layer's backward, with its delta and
dK / dV kernels) at the card's bf16 peak, over the device time of every
flash kernel in the trace (reference/counts.py).  The kernels layer;
moves train_step_ms."""

from port_bench.reference import counts


def read(obs):
    m, tr = obs["model"], obs["trace"]
    shape = (obs["batch"], m["n_head"], obs["seq_len"],
             m["n_embd"] // m["n_head"])
    ops = (len(tr.kernels("flash_fwd")) * counts.flash_fwd_flops(*shape)
           + len(tr.kernels("flash_bwd_dq")) * counts.flash_bwd_flops(*shape))
    t = sum(s for _, s in tr.kernels("flash_fwd", "flash_bwd"))
    return counts.share(ops, counts.PEAK_BF16_FLOPS, t)
