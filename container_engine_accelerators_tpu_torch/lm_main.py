"""Transformer LM training job: the port of demo/tpu-training/lm_main.py.

    python -m container_engine_accelerators_tpu_torch.lm_main [flags]

The same flags and defaults as the reference (seq 2048, batch 8, dim
1024, depth 8, vocab 32000, lr 3e-4, heads dim // 128; --mode dp / sp /
tp / pp / ep, --seq-parallel, --seq-layout, --micro, --virtual,
--experts, --distributed, --model-dir), plus --device (default cuda;
the job exits 2 without a card unless given --device cpu) and --ranks
(CPU only).  "Chips" are ranks, one process each: without
--distributed the job starts one rank per visible card (the reference
takes every local chip), or --ranks N on the CPU; with --distributed
across hosts each host starts as many, its local ranks of the group
the env contract describes (parallel/distributed.py).  On one rank --mode dp
trains without a mesh; every other mode needs more than one, with the
reference's refusals and roundings, exit 2 where it exits 2:
--seq-parallel on one rank degrades to dp with a warning; tp rounds its
default heads to divide the ranks; pp rounds the batch to the
microbatches and picks n_virtual; ep rounds the batch to the ranks.

--arch deepseek_v3 (port-only) trains a DeepSeek-V3-style decoder
(models/mla_moe_lm.py: latent attention, SwiGLU, the dropless expert
layer) instead of the reference's transformer, its widths from
--arch-config, a Hugging Face `deepseek_v3` config.json (e.g.
port_bench/configs/moonlight-16b-a3b.json, Moonlight-16B-A3B as one
card's share of an 8-way expert-parallel job; --dim, --depth, --vocab,
--heads and --experts do not apply).  It trains on one card, --mode dp,
and refuses more ranks (the expert exchange is not built) and
--model-dir where the card holds a share of the experts (one share
cannot be put together into the whole model alone).

Attention and loss resolve as the reference's do on its accelerator:
flash and the fused loss on the card where the shapes allow, and remat
only where the resolved attention is the dense one.  One batch is drawn
and reused for every step, and reading the loss is the timing fence.
Rank 0 logs the reference's lines: `step N loss L tokens/sec T (T/chip)`
every --log-every steps, then `done: ...`.  --model-dir restores the
newest checkpoint before the warm-up step (`resumed from step N`) and
saves checkpoint_<step> after the last (utils/checkpoint.py; every rank
takes part, rank 0 writes), in the one-rank trainer's format, so a
checkpoint written at one world size restores at another.
"""

from __future__ import annotations

import argparse
import logging
import os
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
        help="Parallelism over the ranks: dp (batch), sp (sequence / "
        "ring attention), tp (megatron tensor parallel), pp "
        "(interleaved pipeline), ep (mixture-of-experts).  All but dp "
        "need >1 chip")
    p.add_argument("--seq-parallel", action="store_true",
                   help="Deprecated alias for --mode sp")
    p.add_argument("--micro", type=int, default=0,
                   help="pp: microbatch count (0 = max(16, n_chips))")
    p.add_argument("--virtual", type=int, default=0,
                   help="pp: virtual stages per rank (0 = 2 when depth "
                   "divides, else 1)")
    p.add_argument("--experts", type=int, default=0,
                   help="ep: expert count (0 = one per chip)")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host: torch.distributed from the plugin's "
                   "env contract (TPU_WORKER_*, MEGASCALE_*)")
    p.add_argument("--seq-layout", choices=["contiguous", "zigzag"],
                   default="contiguous",
                   help="Sequence layout under --mode sp: zigzag balances "
                   "the causal ring")
    p.add_argument(
        "--attn-impl", choices=["auto", "dense", "flash"], default="auto",
        help="auto picks the flash kernel on the card when shapes allow")
    p.add_argument("--heads", type=int, default=0,
                   help="Attention heads (0 = dim//128)")
    p.add_argument("--model-dir", default="",
                   help="Restore the newest checkpoint here, and save one "
                   "after the last step")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--arch", choices=["transformer", "deepseek_v3"],
                   default="transformer",
                   help="deepseek_v3: the DeepSeek-V3-style decoder "
                   "(latent attention, dropless experts) of --arch-config")
    p.add_argument("--arch-config", default="",
                   help="--arch deepseek_v3: a deepseek_v3 config.json "
                   "giving every width")
    p.add_argument("--ranks", type=int, default=0,
                   help="CPU only: start this many ranks a host (gloo); "
                   "the card takes one rank per visible card")
    return p.parse_args(argv)


class Refusal(Exception):
    """A configuration the reference refuses (exit 2)."""


def plan(args, n_chips: int, log) -> dict:
    """The reference's mode checks and roundings for `n_chips` ranks:
    the resolved mode, heads, batch and pp / ep settings, or Refusal."""
    if args.seq_parallel and args.mode not in ("dp", "sp"):
        raise Refusal(
            f"--seq-parallel (deprecated alias for --mode sp) conflicts "
            f"with --mode {args.mode}; drop one")
    mode = "sp" if args.seq_parallel else args.mode
    if args.arch == "deepseek_v3":
        return _plan_deepseek_v3(args, mode, n_chips)
    if mode != "dp" and n_chips <= 1:
        if args.seq_parallel:
            log.warning(
                "--seq-parallel with 1 visible chip: training single-chip")
            mode = "dp"
        else:
            raise Refusal(f"--mode {mode} needs >1 chip ({n_chips} visible)")
    if args.seq_layout == "zigzag" and mode != "sp":
        raise Refusal("--seq-layout zigzag needs --mode sp and >1 chip; "
                      "refusing to silently run the contiguous layout")
    out = dict(mode=mode, heads=args.heads or max(1, args.dim // 128),
               batch=args.batch)
    if mode == "tp":
        heads = out["heads"]
        if heads % n_chips:
            if args.heads:
                raise Refusal(f"tp: --heads {args.heads} does not divide "
                              f"over {n_chips} chips")
            rounded = n_chips * -(-heads // n_chips)
            if args.dim % rounded:
                raise Refusal(
                    f"tp: no head count divides both dim {args.dim} and "
                    f"{n_chips} chips (tried {rounded}); set --heads "
                    "explicitly")
            out["heads"] = rounded
            log.info("tp: rounded default heads to %d (divides %d chips)",
                     rounded, n_chips)
        if (4 * args.dim) % n_chips:
            raise Refusal(f"tp: MLP hidden {4 * args.dim} must divide over "
                          f"{n_chips} chips")
    elif mode == "pp":
        n_micro = args.micro or max(16, n_chips)
        if out["batch"] % n_micro:
            out["batch"] = n_micro * -(-out["batch"] // n_micro)
            log.info("pp: rounded batch to %d (%d microbatches)",
                     out["batch"], n_micro)
        n_virtual = args.virtual or (
            2 if args.depth % (2 * n_chips) == 0 and n_micro >= n_chips
            else 1)
        if args.depth % (n_chips * n_virtual):
            raise Refusal(
                f"pp: depth {args.depth} must split evenly over {n_chips} "
                f"stages x {n_virtual} virtual chunks")
        out.update(n_micro=n_micro, n_virtual=n_virtual)
    elif mode == "ep":
        experts = args.experts or n_chips
        if experts % n_chips:
            raise Refusal(f"ep: --experts {args.experts} must divide over "
                          f"{n_chips} chips")
        if out["batch"] % n_chips:
            out["batch"] = n_chips * -(-out["batch"] // n_chips)
            log.info("ep: rounded batch to %d (divides %d chips)",
                     out["batch"], n_chips)
        out["experts"] = experts
    return out


def _plan_deepseek_v3(args, mode, n_chips) -> dict:
    """--arch deepseek_v3's plan: one card, dp, its config read."""
    import json

    if not args.arch_config:
        raise Refusal("--arch deepseek_v3 takes its widths from "
                      "--arch-config (a deepseek_v3 config.json)")
    if mode != "dp" or n_chips != 1:
        raise Refusal(
            f"--arch deepseek_v3 trains one card's share without the "
            f"expert exchange: --mode dp on 1 chip (got --mode {mode}, "
            f"{n_chips} chips)")
    try:
        with open(args.arch_config) as f:
            cfg = json.load(f)
    except (OSError, ValueError) as e:
        raise Refusal(f"--arch-config {args.arch_config}: {e}") from e
    held, total = cfg["n_routed_experts"], cfg.get(
        "experts_total", cfg["n_routed_experts"])
    if args.model_dir and held < total:
        raise Refusal(
            f"--model-dir: this card holds {held} of {total} experts, a "
            "share that cannot be saved as the whole model alone")
    return dict(mode=mode, batch=args.batch, arch_cfg=cfg)


def _build(args, p, device, n_chips, log):
    """(step_fn returning (state, loss), state, batch_fn) for plan p."""
    from .models import transformer as T
    from .parallel import mesh as M

    if "arch_cfg" in p:
        from .models import mla_moe_lm

        log.info("deepseek_v3 decoder from %s", args.arch_config)
        return mla_moe_lm.build_mla_moe_training(
            p["arch_cfg"], seq_len=args.seq_len, batch=p["batch"],
            learning_rate=args.learning_rate, attn_impl=args.attn_impl,
            device=device)

    common = dict(vocab=args.vocab, dim=args.dim, depth=args.depth,
                  heads=p["heads"], seq_len=args.seq_len, batch=p["batch"],
                  learning_rate=args.learning_rate, attn_impl=args.attn_impl,
                  device=device)
    mode = p["mode"]
    if mode in ("dp", "sp"):
        if mode == "sp":
            mesh, seq_axis = M.make_mesh(model_parallel=n_chips), M.MODEL_AXIS
            log.info("sequence parallel over %d chips (ring attention)",
                     n_chips)
        elif n_chips > 1:
            mesh, seq_axis = M.make_mesh(), None
            log.info("data parallel over %d chips", n_chips)
        else:
            mesh, seq_axis = None, None
        # Dense attention at long context needs remat (full score
        # tensors); flash and the ring run cheaper without it.
        remat = seq_axis is None and T.resolve_attn(
            args.attn_impl, args.seq_len, device=device
        ) is T.full_causal_attention
        return T.build_lm_training(mesh=mesh, seq_axis=seq_axis, remat=remat,
                                   seq_layout=args.seq_layout, **common)
    if mode == "tp":
        out = T.build_lm_training_tp(M.mesh_1d(M.MODEL_AXIS), M.MODEL_AXIS,
                                     **common)
        log.info("tensor parallel over %d chips (megatron sharding)",
                 n_chips)
        return out
    if mode == "pp":
        from .models import pipeline_lm as PL

        step, state, batch_fn, info = PL.build_lm_training_pp(
            M.mesh_1d("pp"), "pp", p["n_micro"], n_virtual=p["n_virtual"],
            **common)
        log.info("pipeline over %d stages x %d virtual, %d microbatches, "
                 "bubble %.2f", info["n_stages"], info["n_virtual"],
                 info["n_micro"], info["bubble_fraction"])
        return step, state, batch_fn
    from .models import moe_lm

    moe_step, state, batch_fn = moe_lm.build_moe_lm_training(
        M.mesh_1d("ep"), "ep", n_experts=p["experts"], **common)

    def step(state, tokens, targets):
        state, (loss, _aux, _drop) = moe_step(state, tokens, targets)
        return state, loss

    log.info("expert parallel over %d chips (top-2 MoE)", n_chips)
    return step, state, batch_fn


def train(args, p, device, n_chips, rank=0) -> int:
    """The training loop on this rank; rank 0 logs."""
    import torch

    log = logging.getLogger("lm_main")
    if rank:
        log.setLevel(logging.WARNING)
    step_fn, state, batch_fn = _build(args, p, device, n_chips, log)
    if args.model_dir:
        from .utils import checkpoint as ckpt

        if ckpt.restore_checkpoint(args.model_dir, state) is not None:
            log.info("resumed from step %d", state["step"])
    batch = p["batch"]
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
            tps = batch * args.seq_len * window_steps / (now - window_t0)
            log.info("step %d loss %.3f tokens/sec %.0f (%.0f/chip)",
                     step, loss_val, tps, tps / n_chips)
            window_t0, window_steps = now, 0
    float(loss)
    total = time.perf_counter() - t0
    tps = batch * args.seq_len * args.train_steps / total
    log.info("done: %d steps in %.1fs, %.0f tokens/sec (%.0f/chip)",
             args.train_steps, total, tps, tps / n_chips)
    if args.model_dir:
        ckpt.save_checkpoint(args.model_dir, state, state["step"])
    return 0


def rank_main(rank, world, argv, plan_, device) -> int:
    """One spawned rank (parallel/launch.py): logging, then train."""
    import torch

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return train(parse_args(argv), plan_, dev, world, rank)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    log = logging.getLogger("lm_main")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    import torch

    from ._device import resolve_device
    from .parallel import distributed, launch

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log.error("%s", e)
        return 2
    if args.ranks and device.type == "cuda":
        log.error("--ranks is for the CPU; on the card each visible card "
                  "is a rank")
        return 2
    local = (torch.cuda.device_count() if device.type == "cuda"
             else max(1, args.ranks))
    cluster = (distributed.cluster_from_env(os.environ) if args.distributed
               else None)
    if args.distributed and cluster is None:
        log.info("single-host slice; skipping torch.distributed init")
    n_chips = local if cluster is None else cluster[1] * local
    try:
        p = plan(args, n_chips, log)
    except Refusal as e:
        log.error("%s", e)
        return 2
    if n_chips == 1:
        return train(args, p, device, n_chips)
    return launch.spawn_ranks(
        "container_engine_accelerators_tpu_torch.lm_main:rank_main",
        local, (argv, p, device.type), device=device.type, cluster=cluster)


if __name__ == "__main__":
    sys.exit(main())
