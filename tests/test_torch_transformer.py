"""The port's TransformerLM (container_engine_accelerators_tpu_torch/
models/transformer.py) against the reference flax module on the same
numpy-drawn weights, in f32: the training forward, the chunked-prefill
(scalar write_pos) path, and the paged single-token step, each to
logits within 1e-4; a paged write past the view lands in the null page;
and the weight converter round-trips every parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model,
    rand_prompt,
)
from container_engine_accelerators_tpu.models import generate as G
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import (
    generate as TG,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return draw_params(0)


def test_training_forward_matches(params):
    toks = rand_prompt(1, 12)
    full = T.TransformerLM(dtype=jnp.float32, **CFG)
    ref = np.asarray(full.apply({"params": jax_params(params)},
                                jnp.asarray(toks)))
    got = port_model(params, decode=False)(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_chunked_prefill_matches(params):
    # Three chunks at explicit offsets into a batch-1 scratch: the
    # logits of every chunk and the scratch KV both match.
    dec, jp = jax_decoder(), jax_params(params)
    pm = port_model(params)
    prompt = rand_prompt(2, 24)
    jcache = G.init_decode_cache(dec, 1)
    tcache = TG.init_decode_cache(pm, 1, device="cpu")
    for start in (0, 8, 16):
        chunk = prompt[:, start:start + 8]
        pos = start + np.arange(8, dtype=np.int32)
        jl, upd = dec.apply(
            {"params": jp, "cache": jcache}, jnp.asarray(chunk),
            positions=jnp.asarray(pos), write_pos=jnp.int32(start),
            mutable=["cache"],
        )
        jcache = upd["cache"]
        tl = pm(torch.from_numpy(chunk), positions=torch.from_numpy(pos),
                cache=tcache, write_pos=start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(CFG["depth"]):
        np.testing.assert_allclose(
            tcache[i]["k"].numpy(),
            np.asarray(jcache[f"block_{i}"]["cached_key"]), atol=ATOL,
        )


def _paged_layout(seed):
    """A pool of 20 pages with random KV, 3 rows of 8 logical pages:
    row 2 shares row 0's first page and leaves its tail unmapped."""
    rng = np.random.default_rng(seed)
    d_head = CFG["dim"] // CFG["heads"]
    shape = (20, PAGE, CFG["heads"], d_head)
    pools = [
        {"k": rng.standard_normal(shape).astype(np.float32),
         "v": rng.standard_normal(shape).astype(np.float32)}
        for _ in range(CFG["depth"])
    ]
    per_row = CFG["max_seq"] // PAGE
    bt = np.arange(1, 1 + 3 * per_row, dtype=np.int32).reshape(3, per_row)
    bt = np.where(bt < 20, bt, 0).astype(np.int32)
    bt[2, 0] = bt[0, 0]
    bt[2, 3:] = 0
    pos = np.array([40, 15, 20], np.int32)
    return pools, bt, pos


def test_paged_single_token_step_matches(params):
    dec, jp = jax_decoder(), jax_params(params)
    pm = port_model(params)
    pools, bt, pos = _paged_layout(3)
    toks = np.array([[5], [17], [42]], np.int32)
    view = bt.shape[1] * PAGE
    mask = np.arange(view)[None, :] <= pos[:, None]
    jcache = {
        f"block_{i}": {
            "cached_key": jnp.asarray(p["k"]),
            "cached_value": jnp.asarray(p["v"]),
            "cache_index": jnp.zeros((), jnp.int32),
        }
        for i, p in enumerate(pools)
    }
    jl, upd = dec.apply(
        {"params": jp, "cache": jcache}, jnp.asarray(toks),
        positions=jnp.asarray(pos[:, None]), kv_mask=jnp.asarray(mask),
        write_pos=jnp.asarray(pos), block_tables=jnp.asarray(bt),
        mutable=["cache"],
    )
    tcache = [
        {"k": torch.from_numpy(p["k"].copy()),
         "v": torch.from_numpy(p["v"].copy())} for p in pools
    ]
    tl = pm(
        torch.from_numpy(toks), positions=torch.from_numpy(pos[:, None]),
        cache=tcache, kv_mask=torch.from_numpy(mask),
        write_pos=torch.from_numpy(pos), block_tables=torch.from_numpy(bt),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(CFG["depth"]):
        np.testing.assert_allclose(
            tcache[i]["v"].numpy(),
            np.asarray(upd["cache"][f"block_{i}"]["cached_value"]),
            atol=ATOL,
        )


def test_paged_write_past_view_lands_in_null_page(params):
    pm = port_model(params)
    pools, bt, pos = _paged_layout(4)
    view = bt.shape[1] * PAGE
    pos = np.array([view + 3, 15, 20], np.int32)  # row 0 past its view
    mask = np.arange(view)[None, :] <= np.minimum(pos, view - 1)[:, None]
    tcache = [
        {"k": torch.from_numpy(p["k"].copy()),
         "v": torch.from_numpy(p["v"].copy())} for p in pools
    ]
    pm(
        torch.tensor([[1], [2], [3]]), positions=torch.tensor(
            [[view - 1], [15], [20]]),
        cache=tcache, kv_mask=torch.from_numpy(mask),
        write_pos=torch.from_numpy(pos), block_tables=torch.from_numpy(bt),
    )
    for i, p in enumerate(pools):
        changed = np.argwhere(
            np.any(tcache[i]["k"].numpy() != p["k"], axis=(2, 3))
        )
        got = {tuple(c) for c in changed.tolist()}
        # Row 0 -> null page 0 slot 0; rows 1, 2 -> their own slots.
        want = {(0, 0), (int(bt[1, 15 // PAGE]), 15 % PAGE),
                (int(bt[2, 20 // PAGE]), 20 % PAGE)}
        assert got == want, (i, got, want)


def test_converter_round_trips_every_param(params):
    back = convert.to_flax_params(port_model(params))
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        assert path in flat_out, path
        assert flat_out[path].shape == leaf.shape, path
        assert flat_out[path].tobytes() == leaf.tobytes(), path


def test_converter_rejects_depth_mismatch(params):
    with pytest.raises(ValueError, match="depth"):
        port_model(params, cfg=dict(CFG, depth=3))
