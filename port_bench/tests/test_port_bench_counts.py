"""The operation and byte counts against counts by hand at small size."""

from port_bench.reference import counts

M = {"n_embd": 4, "n_layer": 2, "n_head": 2, "vocab_size": 10}


def test_decode_token():
    # a layer: q/k/v 2*4*12, proj 2*4*4, mlp 2*4*16 + 2*16*4 = 384;
    # attention over 3 positions: 2*4*3 + 2*4*3 = 48; head 2*4*10 = 80
    assert counts.decode_token_flops(M, 3) == 2 * (384 + 48) + 80


def test_prefill():
    # positions 2 and 3 attend to 3 and 4 positions
    per = 2 * (384 * 2 + 16 * 3 + 16 * 4)
    assert counts.prefill_flops(M, 2, 4) == per + 80
    assert counts.prefill_flops(M, 4, 4) == 0


def test_train_step():
    # one sequence of 2: layers 2 * (2 * 384 + 8 * (1 + 2)), head 2 * 80
    fwd = 2 * (2 * 384 + 16 * 3) + 2 * 80
    assert counts.train_step_flops(M, 1, 2) == 3 * fwd


def test_flash():
    # b 1, h 2, s 3, d 4: 6 visible pairs a head, 4 ops a pair a dim
    assert counts.flash_fwd_flops(1, 2, 3, 4) == 4 * 2 * 4 * 6
    assert counts.flash_bwd_flops(1, 2, 3, 4) == 2.5 * 4 * 2 * 4 * 6


def test_paged_bytes_and_share():
    # K and V of 5 positions, 4 wide, bf16, plus q and out: per layer
    assert counts.paged_attn_bytes(M, 5) == 2 * (2 * 5 * 4 * 2 + 2 * 4 * 2)
    assert counts.share(3.35e12, counts.HBM_BYTES_PER_S, 2.0) == 50.0
    assert counts.share(0, counts.HBM_BYTES_PER_S, 2.0) is None
