"""ResNet training job: the port of demo/tpu-training/resnet_main.py.

    python -m container_engine_accelerators_tpu_torch.resnet_main [flags]

The same flags and defaults as the reference (ResNet-50, 200 steps,
batch 256 per chip, 224 x 224 images, lr 0.1, a log line every 20 steps,
one step per call), plus --device (default cuda; the job exits 2 without
a card unless given --device cpu) and --ranks (CPU only).  Like the
reference it builds the model at its defaults (block_impl "flax",
norm_impl "fused", the conv7 stem), which run no hand-written kernel.
Each step draws a fresh synthetic batch on the device; --steps-per-call
K > 1 runs K steps per call of `build_scan_training`.  Reading the loss
is the timing fence.  The log lines are the reference's: `training ...
on N devices (kind), global batch N`, `step N loss L images/sec I
(I/chip)` every --log-every steps, then `done: ...`.  --profile-dir
writes a torch.profiler trace (Chrome JSON) of one more steady-state
step (or call) into that directory.

--model inception_v3 trains models/inception.py's Inception v3 (the
reference's demo job runs it at --image-size 299 --batch-per-chip 128).
--model-dir saves checkpoint_<step> there after the last step
(utils/checkpoint.py, torch-native files); like the reference's job it
does not restore.

"Chips" are ranks, one process each, as in lm_main: without
--distributed the job starts one rank per visible card (the reference
takes every local chip), or --ranks N gloo ranks on the CPU; with
--distributed across hosts (the plugin's env contract, read by
parallel/distributed.py) each host starts as many, its local ranks of
the global group, and on one host it initializes nothing and takes its
local ranks.  On one rank the job trains in this process without a
mesh.  On more, each rank (`rank_main`) trains data parallel over the
group's mesh: the global batch is batch-per-chip times the ranks, every
rank draws it and trains its share, BatchNorm takes the global batch's
statistics (models/train.py); rank 0 logs, writes the checkpoint (every
rank takes part; the one-rank trainer's format) and the trace.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "inception_v3"])
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--batch-per-chip", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="Steps per call: 1 = one call per step; >1 runs K "
                   "steps per call, each batch drawn on the device")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host: torch.distributed from the plugin's "
                   "env contract (TPU_WORKER_*, MEGASCALE_*) before "
                   "building the mesh")
    p.add_argument("--model-dir", default="",
                   help="Save a checkpoint here after the last step")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler trace of one steady-state "
                   "step into this directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--ranks", type=int, default=0,
                   help="CPU only: start this many ranks a host (gloo); "
                   "on the card each visible card is a rank")
    return p.parse_args(argv)


def train(args, device, n_chips, rank=0, mesh=None) -> int:
    """The training loop on this rank (over `mesh` when given); rank 0
    logs and traces."""
    import torch

    from .models import train as train_mod

    log = logging.getLogger("resnet_main")
    if rank:
        log.setLevel(logging.WARNING)
    global_batch = args.batch_per_chip * n_chips
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log.info("training %s on %d devices (%s), global batch %d",
             args.model, n_chips, kind, global_batch)

    gen = torch.Generator(device=device).manual_seed(0)
    if args.steps_per_call > 1:
        multi, state = train_mod.build_scan_training(
            mesh=mesh, model_name=args.model, image_size=args.image_size,
            learning_rate=args.learning_rate,
            steps_per_call=args.steps_per_call, global_batch=global_batch,
            device=device,
        )
        state, loss = multi(state, gen)  # warm-up
        float(loss)
        calls = max(1, args.train_steps // args.steps_per_call)
        t0 = time.perf_counter()
        window_t0, window_steps, done = t0, 0, 0
        for call in range(1, calls + 1):
            state, loss = multi(state, gen)
            window_steps += args.steps_per_call
            done += args.steps_per_call
            if (call * args.steps_per_call) % args.log_every < (
                args.steps_per_call
            ):
                loss_val = float(loss)  # the timing fence
                now = time.perf_counter()
                ips = global_batch * window_steps / (now - window_t0)
                log.info("step %d loss %.3f images/sec %.0f (%.0f/chip)",
                         done, loss_val, ips, ips / n_chips)
                window_t0, window_steps = now, 0
        float(loss)
        total = time.perf_counter() - t0
        args.train_steps = done

        def profile_step(state):
            return multi(state, gen)
    else:
        step_fn, batch_fn, state = train_mod.build_training(
            mesh=mesh, model_name=args.model, image_size=args.image_size,
            learning_rate=args.learning_rate, device=device,
        )
        images, labels = batch_fn(gen, global_batch)
        state, loss = step_fn(state, images, labels)  # warm-up
        float(loss)
        t0 = time.perf_counter()
        window_t0, window_steps = t0, 0
        for step in range(1, args.train_steps + 1):
            images, labels = batch_fn(gen, global_batch)
            state, loss = step_fn(state, images, labels)
            window_steps += 1
            if step % args.log_every == 0:
                loss_val = float(loss)  # the timing fence
                now = time.perf_counter()
                ips = global_batch * window_steps / (now - window_t0)
                log.info("step %d loss %.3f images/sec %.0f (%.0f/chip)",
                         step, loss_val, ips, ips / n_chips)
                window_t0, window_steps = now, 0
        float(loss)
        total = time.perf_counter() - t0

        def profile_step(state):
            images, labels = batch_fn(gen, global_batch)
            return step_fn(state, images, labels)

    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # Every rank steps (the collectives); rank 0 traces.
        prof = None if rank else profile(activities=acts)
        if prof is not None:
            log.info("capturing profiler trace to %s", args.profile_dir)
            os.makedirs(args.profile_dir, exist_ok=True)
        with prof or contextlib.nullcontext():
            state, loss = profile_step(state)
            float(loss)
        if prof is not None:
            prof.export_chrome_trace(
                os.path.join(args.profile_dir, "resnet_main_trace.json"))

    ips = global_batch * args.train_steps / total
    log.info("done: %d steps in %.1fs, %.0f images/sec (%.0f/chip)",
             args.train_steps, total, ips, ips / n_chips)
    if args.model_dir:
        from .utils import checkpoint as ckpt

        ckpt.save_checkpoint(args.model_dir, state, state["step"])
    return 0


def rank_main(rank, world, argv, device) -> int:
    """One spawned rank (parallel/launch.py): logging, the mesh over the
    group, then train.  CUDA is first touched after init_rank set this
    rank's card."""
    import torch

    from .parallel import mesh as M

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return train(parse_args(argv), dev, world, rank, M.make_mesh())


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    log = logging.getLogger("resnet_main")
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
    if n_chips == 1:
        return train(args, device, n_chips)
    return launch.spawn_ranks(
        "container_engine_accelerators_tpu_torch.resnet_main:rank_main",
        local, (argv, device.type), device=device.type, cluster=cluster)


if __name__ == "__main__":
    sys.exit(main())
