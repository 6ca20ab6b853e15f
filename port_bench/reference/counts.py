"""Operations and bytes of the work, counted from shapes, and the card's
published peaks.  They depend on what the work needs, never on how the
program does it, so a later kernel cannot make them stale.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.

A GPT-2 layer, per token, counting a multiply-add as two operations:
q/k/v 2·D·3D, the output projection 2·D·D, the MLP 2·D·4D + 2·4D·D, so
24·D² in all; attention over a context of c positions 2·D·c for q·k
and 2·D·c for p·v.  The head is 2·D·V a row that is sampled.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_matmul_flops(d):
    return 24 * d * d


def attn_flops(d, ctx):
    """q·k and p·v of one token over `ctx` visible positions, one layer."""
    return 4 * d * ctx


def head_flops(d, vocab):
    return 2 * d * vocab


def decode_token_flops(model, ctx):
    """One generated token whose step sees `ctx` positions (itself
    included): every layer, and the head."""
    d, n_layer = model["n_embd"], model["n_layer"]
    return (n_layer * (layer_matmul_flops(d) + attn_flops(d, ctx))
            + head_flops(d, model["vocab_size"]))


def prefill_flops(model, start, end):
    """Prompt positions [start, end) run through every layer, each
    attending causally to positions 0..p, and the head on the last row
    (the one that samples)."""
    d, n_layer = model["n_embd"], model["n_layer"]
    n = end - start
    if n <= 0:
        return 0
    ctx_sum = (end * (end + 1) - start * (start + 1)) // 2  # sum of p + 1
    return (n_layer * (n * layer_matmul_flops(d) + 4 * d * ctx_sum)
            + head_flops(d, model["vocab_size"]))


def train_step_flops(model, batch, seq):
    """Forward and backward (3x the forward) of one step of `batch`
    sequences of `seq` tokens: every layer, causal attention, and the
    head on every row."""
    d, n_layer = model["n_embd"], model["n_layer"]
    ctx_sum = seq * (seq + 1) // 2
    fwd = batch * (n_layer * (seq * layer_matmul_flops(d) + 4 * d * ctx_sum)
                   + seq * head_flops(d, model["vocab_size"]))
    return 3 * fwd


def flash_fwd_flops(batch, heads, seq, d_head):
    """Causal attention forward of one layer: q·k and p·v over the
    positions each query sees (p + 1 of them)."""
    return 4 * batch * heads * d_head * (seq * (seq + 1) // 2)


def flash_bwd_flops(batch, heads, seq, d_head):
    """Its backward: p recomputed (q·k), dV, dP, dQ and dK, five products
    for the forward's two."""
    return 2.5 * flash_fwd_flops(batch, heads, seq, d_head)


def paged_attn_bytes(model, ctx, kv_bytes=2, act_bytes=2):
    """Bytes one token's decode attention needs over every layer: the K
    and V rows of its `ctx` visible positions, its q read and its output
    written."""
    d, n_layer = model["n_embd"], model["n_layer"]
    return n_layer * (2 * ctx * d * kv_bytes + 2 * d * act_bytes)


def share(ops_or_bytes, rate, seconds):
    """Percent of the peak `rate` that `ops_or_bytes` in `seconds` reach,
    or None where nothing ran."""
    if seconds <= 0 or ops_or_bytes <= 0:
        return None
    return 100.0 * ops_or_bytes / rate / seconds
