"""The port's single-chip LM trainer (container_engine_accelerators_tpu_
torch/models/transformer.py `build_lm_training`) against the reference's
on the same numpy-drawn flax params and tokens, on the CPU:

  (a) f32 at the harness's tiny config, seq 128: the forward's logits,
      the loss and every parameter's gradient against flax's
      value_and_grad, within 1e-4 of each leaf's max|value| (f32 sums in
      another order through two blocks, the head and the loss);
  (b) one AdamW update against optax.adamw on the same params and
      gradients, within 1e-6 absolute (the same f32 formula; optax
      divides by the bias corrections before the square root, torch
      after, a few f32 roundings of an lr-sized update);
  (c) both packages' builders in bf16 (the reference's default compute
      type) for 3 steps from the same params and tokens: losses within
      2**-9 relative, half a bf16 ulp (the port rounds every bf16 op's
      result, while XLA on the CPU may keep f32 through a fused chain
      of elementwise ops, so an activation can round the other way; and
      AdamW's first update is about lr * sign(g), which flips where
      that noise flips a tiny gradient);
      the same for 2 steps at the head dims the CUDA kernels are built
      for (64 and 128: dim 128 at 2 heads and at 1), through
      attn_impl="flash";
  (d) the attention and loss selection, the validation messages beside
      the reference's, and the NotImplementedErrors of what is not
      ported;
  (e) the chunked vocab head (head_impl="chunked", ops/chunked_xent.py):
      in f32 the step's loss and every gradient against flax's
      value_and_grad through the reference's chunked loss, within 1e-4
      of each leaf's max|value| as (a), at a chunk that divides the
      vocab and one that does not; and both packages' chunked builders
      in bf16 for 3 steps, losses within 2**-9 relative as (c).

The port's flash and fused-loss wrappers run their plain versions here,
so (a) and (c) also drive attn_impl="flash", loss_impl="fused" against
the reference's dense / xla path (the reference's kernels do not run on
the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import CFG, draw_params, jax_params
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops.losses import (
    cross_entropy_loss as jax_xent,
)
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import (
    transformer as PT,
)
from container_engine_accelerators_tpu_torch.ops import (
    flash_attention as TF,
)

SEQ, BATCH, LR = 128, 2, 1e-3
TRAIN_CFG = dict(CFG, max_seq=SEQ)
MODEL_KW = {k: TRAIN_CFG[k] for k in ("vocab", "dim", "depth", "heads")}
PATHS = [  # (attn_impl, loss_impl, remat)
    ("dense", "xla", False),
    ("flash", "fused", False),
    ("dense", "xla", True),
]


@pytest.fixture(scope="module")
def params():
    return draw_params(5, TRAIN_CFG)


def _tokens(seed):
    tok = np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=(BATCH, SEQ + 1)
    ).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_close(got, want, rel):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path),
        )


def _port_trainer(params, dtype, attn_impl="auto", loss_impl="auto",
                  remat=False):
    return PT.build_lm_training(
        **MODEL_KW, seq_len=SEQ, batch=BATCH, learning_rate=LR,
        remat=remat, attn_impl=attn_impl, loss_impl=loss_impl,
        dtype=dtype, device="cpu", params=params,
    )


@pytest.mark.parametrize("attn_impl,loss_impl,remat", PATHS)
def test_f32_logits_loss_and_gradients_match_flax(params, attn_impl,
                                                  loss_impl, remat):
    tokens, targets = _tokens(1)
    model = T.TransformerLM(dtype=jnp.float32, **TRAIN_CFG)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_xent(logits.reshape(-1, CFG["vocab"]),
                        jnp.asarray(targets).reshape(-1)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax_params(params))

    step, state, _ = _port_trainer(
        params, torch.float32, attn_impl, loss_impl, remat
    )
    tt, tg = torch.from_numpy(tokens), torch.from_numpy(targets)
    with torch.no_grad():
        t_logits = state["model"](tt).numpy()
    np.testing.assert_allclose(
        t_logits, np.asarray(j_logits), rtol=0,
        atol=1e-4 * np.abs(np.asarray(j_logits)).max(),
    )
    state, t_loss = step(state, tt, tg)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    _assert_trees_close(
        convert.to_flax_grads(state["model"]), j_grads, rel=1e-4
    )


def test_one_adamw_update_matches_optax(params):
    # The port's step leaves its gradients on the parameters: feed the
    # same params and gradients to optax.adamw and compare the update.
    tokens, targets = _tokens(2)
    step, state, _ = _port_trainer(params, torch.float32, "dense", "xla")
    state, _ = step(state, torch.from_numpy(tokens),
                    torch.from_numpy(targets))
    assert state["step"] == 1
    grads = convert.to_flax_grads(state["model"])
    tx = optax.adamw(LR)
    p0 = jax_params(params)
    updates, _ = tx.update(jax_params(grads), tx.init(p0), p0)
    want = optax.apply_updates(p0, updates)
    got = convert.to_flax_params(state["model"])
    for path, w in _leaves(want).items():
        np.testing.assert_allclose(
            _leaves(got)[path], np.asarray(w), rtol=0, atol=1e-6,
            err_msg=jax.tree_util.keystr(path),
        )


@pytest.mark.parametrize("attn_impl,loss_impl", [
    ("auto", "auto"), ("flash", "fused"),
])
def test_bf16_builders_agree_for_three_steps(params, attn_impl, loss_impl):
    tokens, targets = _tokens(3)
    j_step, _, _ = T.build_lm_training(
        **MODEL_KW, seq_len=SEQ, batch=BATCH, learning_rate=LR,
    )
    p = jax_params(params)
    j_state = {"params": p, "opt_state": optax.adamw(LR).init(p),
               "step": jnp.zeros((), jnp.int32)}
    t_step, t_state, _ = _port_trainer(
        params, torch.bfloat16, attn_impl, loss_impl
    )
    j_losses, t_losses = [], []
    for _ in range(3):
        j_state, jl = j_step(j_state, jnp.asarray(tokens),
                             jnp.asarray(targets))
        t_state, tl = t_step(t_state, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    assert t_losses[-1] < t_losses[0]  # it trains
    np.testing.assert_allclose(t_losses, j_losses, rtol=2.0 ** -9, atol=0)


@pytest.mark.parametrize("heads,d_head", [(2, 64), (1, 128)])
def test_bf16_trainers_agree_at_kernel_head_dims(heads, d_head):
    cfg = dict(vocab=64, dim=128, depth=1, heads=heads, max_seq=SEQ)
    assert cfg["dim"] // heads == d_head and d_head in TF.HEAD_DIMS
    kw = {k: cfg[k] for k in ("vocab", "dim", "depth", "heads")}
    wide = draw_params(7, cfg)
    tokens, targets = _tokens(4)
    j_step, _, _ = T.build_lm_training(
        **kw, seq_len=SEQ, batch=BATCH, learning_rate=LR,
    )
    p = jax_params(wide)
    j_state = {"params": p, "opt_state": optax.adamw(LR).init(p),
               "step": jnp.zeros((), jnp.int32)}
    t_step, t_state, _ = PT.build_lm_training(
        **kw, seq_len=SEQ, batch=BATCH, learning_rate=LR, attn_impl="flash",
        loss_impl="fused", dtype=torch.bfloat16, device="cpu", params=wide,
    )
    assert t_state["model"].blocks[0].attn_fn is TF.flash_causal_attention
    j_losses, t_losses = [], []
    for _ in range(2):
        j_state, jl = j_step(j_state, jnp.asarray(tokens),
                             jnp.asarray(targets))
        t_state, tl = t_step(t_state, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    assert t_losses[-1] < t_losses[0]  # it trains
    np.testing.assert_allclose(t_losses, j_losses, rtol=2.0 ** -9, atol=0)


@pytest.mark.parametrize("chunk", [16, 24])  # divides vocab 64; does not
def test_f32_chunked_head_loss_and_gradients_match_flax(params, chunk):
    from container_engine_accelerators_tpu.ops.chunked_xent import (
        chunked_softmax_xent,
    )

    tokens, targets = _tokens(6)
    model = T.TransformerLM(dtype=jnp.float32, head_impl="chunked",
                            **TRAIN_CFG)

    def loss_fn(p):
        hidden, k, b = model.apply({"params": p}, jnp.asarray(tokens))
        return chunked_softmax_xent(
            hidden.reshape(-1, CFG["dim"]), k, b,
            jnp.asarray(targets).reshape(-1), chunk_size=chunk)

    j_loss, j_grads = jax.value_and_grad(loss_fn)(jax_params(params))
    step, state, _ = PT.build_lm_training(
        **MODEL_KW, seq_len=SEQ, batch=BATCH, learning_rate=LR,
        head_impl="chunked", head_chunk=chunk, dtype=torch.float32,
        device="cpu", params=params,
    )
    state, t_loss = step(state, torch.from_numpy(tokens),
                         torch.from_numpy(targets))
    assert abs(float(t_loss) - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    _assert_trees_close(
        convert.to_flax_grads(state["model"]), j_grads, rel=1e-4
    )


def test_bf16_chunked_builders_agree_for_three_steps(params):
    tokens, targets = _tokens(8)
    kw = dict(MODEL_KW, seq_len=SEQ, batch=BATCH, learning_rate=LR,
              head_impl="chunked", head_chunk=24)
    j_step, _, _ = T.build_lm_training(**kw)
    p = jax_params(params)
    j_state = {"params": p, "opt_state": optax.adamw(LR).init(p),
               "step": jnp.zeros((), jnp.int32)}
    t_step, t_state, _ = PT.build_lm_training(
        **kw, dtype=torch.bfloat16, device="cpu", params=params)
    j_losses, t_losses = [], []
    for _ in range(3):
        j_state, jl = j_step(j_state, jnp.asarray(tokens),
                             jnp.asarray(targets))
        t_state, tl = t_step(t_state, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    assert t_losses[-1] < t_losses[0]  # it trains
    np.testing.assert_allclose(t_losses, j_losses, rtol=2.0 ** -9, atol=0)


def test_batch_fn_draws_next_token_targets():
    _, _, batch_fn = _port_trainer(None, torch.float32)
    g = torch.Generator().manual_seed(0)
    tokens, targets = batch_fn(g)
    assert tokens.shape == targets.shape == (BATCH, SEQ)
    assert torch.equal(tokens[:, 1:], targets[:, :-1])
    assert int(tokens.max()) < CFG["vocab"] and int(tokens.min()) >= 0
    again, _ = batch_fn(torch.Generator().manual_seed(0))
    assert torch.equal(again, tokens)


def test_attention_and_loss_selection():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert PT._auto_use_flash("auto", 2048, cuda)
    assert not PT._auto_use_flash("auto", 2048, cpu)
    assert not PT._auto_use_flash("auto", 384, cuda)
    assert PT._auto_use_flash("flash", 384, cpu)
    assert not PT._auto_use_flash("dense", 2048, cuda)
    # As in the reference, auto keys on the device and the length only.
    for s in (64, 128, 384, 512, 1024, 2048, 8192):
        assert PT._auto_use_flash("auto", s, cuda) == (
            TF.flash_supports_seq(s))
    assert PT.resolve_attn("auto", 2048, device=cuda) is (
        TF.flash_causal_attention)
    assert PT.resolve_attn("auto", 2048, device=cpu) is (
        PT.full_causal_attention)
    assert PT.resolve_loss("auto", 16384, cuda) == "fused"
    assert PT.resolve_loss("auto", 12, cuda) == "xla"
    assert PT.resolve_loss("auto", 16384, cpu) == "xla"
    assert PT.resolve_loss("fused", 16, cpu) == "fused"


@pytest.mark.parametrize("kw", [
    dict(attn_impl="sparse"),
    dict(loss_impl="bogus"),
    dict(head_impl="sparse"),
    dict(seq_layout="spiral"),
    dict(seq_layout="zigzag"),
    dict(head_impl="chunked", head_chunk=0),
    dict(head_impl="chunked", loss_impl="fused"),
])
def test_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        T.build_lm_training(**kw)
    with pytest.raises(ValueError) as port:
        PT.build_lm_training(device="cpu", **kw)
    assert str(port.value) == str(ref.value)


def test_unported_paths_raise_not_implemented():
    # The chunked head is ported (ops/chunked_xent.py), and the mesh
    # paths (tests/test_torch_lm_parallel.py); a tensor-parallel block
    # has no decode path.
    step, state, batch_fn = PT.build_lm_training(
        head_impl="chunked", head_chunk=300, vocab=1000, dim=32, depth=1,
        heads=2, seq_len=16, batch=2, device="cpu")
    state, loss = step(state, *batch_fn(torch.Generator().manual_seed(0)))
    assert state["step"] == 1 and bool(torch.isfinite(loss))
    blk = PT.TPDecoderBlock(32, 2, torch.float32, "cpu", None, 2)
    with pytest.raises(NotImplementedError, match="decode"):
        blk(torch.zeros(1, 1, 32), cache=[{}])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.build_lm_training()
