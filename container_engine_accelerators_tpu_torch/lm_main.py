"""Transformer LM training job on one card: the port of
demo/tpu-training/lm_main.py's single-chip `--mode dp` path.

    python -m container_engine_accelerators_tpu_torch.lm_main [flags]

The same flags and defaults as the reference (seq 2048, batch 8, dim
1024, depth 8, vocab 32000, lr 3e-4, heads dim // 128), plus --device
(default cuda; the job raises without a card unless given --device cpu).
Attention and loss resolve as the reference's do on its accelerator:
flash and the fused loss on the card where the shapes allow, and remat
only where the resolved attention is the dense one.  One batch is drawn
and reused for every step, and reading the loss is the timing fence.
The log lines are the reference's: `step N loss L tokens/sec T (T/chip)`
every --log-every steps, then `done: ...`.

--model-dir restores the newest checkpoint there before the warm-up step
(logging `resumed from step N`) and saves checkpoint_<step> after the
last step, as the reference does (utils/checkpoint.py, torch-native
files); the warm-up step trains too, so a resumed run of N steps ends
N + 1 steps past the restored one.

Not ported yet, each exits 2 naming its ROADMAP item: the other
parallel modes (--mode sp/tp/pp/ep, --seq-parallel, --seq-layout
zigzag, --distributed: A10).  The pp / ep knobs (--micro, --virtual,
--experts) are parsed and, as in the reference's dp mode, unused.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument(
        "--mode", choices=["dp", "sp", "tp", "pp", "ep"], default="dp",
        help="Parallelism: only dp on one card is ported (ROADMAP A10)",
    )
    p.add_argument("--seq-parallel", action="store_true",
                   help="Deprecated alias for --mode sp (ROADMAP A10)")
    p.add_argument("--micro", type=int, default=0, help="pp only")
    p.add_argument("--virtual", type=int, default=0, help="pp only")
    p.add_argument("--experts", type=int, default=0, help="ep only")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host (ROADMAP A10)")
    p.add_argument("--seq-layout", choices=["contiguous", "zigzag"],
                   default="contiguous",
                   help="zigzag needs --mode sp (ROADMAP A10)")
    p.add_argument(
        "--attn-impl", choices=["auto", "dense", "flash"], default="auto",
        help="auto picks the flash kernel on the card when shapes allow",
    )
    p.add_argument("--heads", type=int, default=0,
                   help="Attention heads (0 = dim//128)")
    p.add_argument("--model-dir", default="",
                   help="Restore the newest checkpoint here, and save one "
                   "after the last step")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    log = logging.getLogger("lm_main")
    args = parse_args(argv)
    if args.mode != "dp" or args.seq_parallel or args.distributed or (
        args.seq_layout == "zigzag"
    ):
        log.error(
            "only single-card --mode dp is ported; sp / tp / pp / ep, "
            "--seq-parallel, --seq-layout zigzag and --distributed come "
            "with the port of parallel/ (ROADMAP A10)"
        )
        return 2
    import torch

    from ._device import resolve_device
    from .models import transformer as T

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log.error("%s", e)
        return 2
    heads = args.heads or max(1, args.dim // 128)
    # Dense attention at long context needs remat (full score tensors);
    # the flash path runs cheaper without it.  Key on the RESOLVED
    # implementation: auto can fall back to dense.
    remat = T.resolve_attn(
        args.attn_impl, args.seq_len, device=device
    ) is T.full_causal_attention
    step_fn, state, batch_fn = T.build_lm_training(
        vocab=args.vocab, dim=args.dim, depth=args.depth, heads=heads,
        seq_len=args.seq_len, batch=args.batch,
        learning_rate=args.learning_rate, remat=remat,
        attn_impl=args.attn_impl, device=device,
    )
    if args.model_dir:
        from .utils import checkpoint as ckpt

        if ckpt.restore_checkpoint(args.model_dir, state) is not None:
            log.info("resumed from step %d", state["step"])

    tokens, targets = batch_fn(torch.Generator().manual_seed(0))
    state, loss = step_fn(state, tokens, targets)  # warm-up
    float(loss)

    t0 = time.perf_counter()
    window_t0, window_steps = t0, 0
    for step in range(1, args.train_steps + 1):
        state, loss = step_fn(state, tokens, targets)
        window_steps += 1
        if step % args.log_every == 0:
            loss_val = float(loss)  # the timing fence
            now = time.perf_counter()
            tps = args.batch * args.seq_len * window_steps / (now - window_t0)
            log.info("step %d loss %.3f tokens/sec %.0f (%.0f/chip)",
                     step, loss_val, tps, tps)
            window_t0, window_steps = now, 0
    float(loss)
    total = time.perf_counter() - t0
    tps = args.batch * args.seq_len * args.train_steps / total
    log.info("done: %d steps in %.1fs, %.0f tokens/sec (%.0f/chip)",
             args.train_steps, total, tps, tps)
    if args.model_dir:
        ckpt.save_checkpoint(args.model_dir, state, state["step"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
