"""The flash kernels' share of their operations bound on latent
attention, in percent: the causal operations at the true widths (q . k
over qk_nope + qk_rope, p . v over v_head_dim, whatever width the kernel
pads v to) of each forward launch (flash_fwd) and each backward (one
flash_bwd_dq a layer's backward, with its delta and dK / dV kernels) at
the card's bf16 peak, over the device time of every flash kernel in the
trace (reference/counts_moonlight.py).  The kernels layer; moves
train_step_ms."""

from port_bench.reference import counts, counts_moonlight


def read(obs):
    m, tr = obs["model"], obs["trace"]
    b, s = obs["batch"], obs["seq_len"]
    ops = (len(tr.kernels("flash_fwd")) * counts_moonlight.mla_fwd_flops(
        m, b, s) + len(tr.kernels("flash_bwd_dq"))
        * counts_moonlight.mla_bwd_flops(m, b, s))
    t = sum(x for _, x in tr.kernels("flash_fwd", "flash_bwd"))
    return counts.share(ops, counts.PEAK_BF16_FLOPS, t)
