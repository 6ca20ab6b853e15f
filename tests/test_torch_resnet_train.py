"""The port's single-card ResNet trainer (container_engine_accelerators_
tpu_torch/models/train.py) and its job (resnet_main) against the
reference's (models/train.py, demo/tpu-training/resnet_main.py), on the
CPU at a tiny ResNet (stages [1, 1], 8 filters, 4 classes, 16 x 16
images, batch 8):

  (a) two SGD updates of the port (torch.optim.SGD, Nesterov) against
      optax's chain(add_decayed_weights(1e-4), sgd(0.1, 0.9, nesterov))
      on the same params and the port's gradients, every leaf within
      1e-6 absolute (the same f32 formula; decay reaches the norm
      scales and biases, never the running statistics);
  (b) both packages' builders in bf16, block_impl "fused_pallas" with
      the s2d stem (this slice's path) and the default flax block, for 3
      steps from the reference's own initial state and the same images
      and labels: the losses within 3e-2 relative, a limit set after
      reading them (steps 1-3: fused 8e-4, 1.4e-3, 1.2e-2; flax 5e-4,
      2.9e-3, 4.9e-3): bf16 activations round at other points in the
      two frameworks (XLA may keep f32 through a fused chain of ops
      where torch rounds each), and SGD at lr 0.1 on a batch of 8 with
      BatchNorm carries each step's difference into the next, growing
      it step by step;
  (c) the builders' contracts (scan: K steps per call on batches drawn
      on the device; bank: the bank's shape and cycle), the synthetic
      batch, the Inception-v3 factory, and the models and norms the
      reference trains under a mesh building there (one gloo rank);
  (d) the job end to end in a subprocess at a tiny size on the CPU: it
      logs the reference's lines; --model-dir writes checkpoint_<step>
      after the last step (the reference's job saves and never
      restores); --model inception_v3 trains at a 75-pixel image;
      --distributed on one host initializes nothing and trains, as the
      reference's does; --ranks 2 trains ResNet-18 and Inception v3 on
      two gloo ranks, rank 0 logging; two visible cards start one rank
      each (spawn_ranks recorded, with a multi-host env contract's
      cluster); without --device cpu and no card it exits 2.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import draw_vision_trees
from container_engine_accelerators_tpu.models import resnet as JR
from container_engine_accelerators_tpu.models import train as JT
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import train as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(stage_sizes=[1, 1], num_filters=8)
CLASSES, IMAGE, BATCH, LR = 4, 16, 8, 0.1


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(BATCH,)).astype(np.int32)
    return images, labels


def _port_images(images):
    # bf16 images, as synthetic_batch draws them in both packages.
    return torch.from_numpy(images).to(torch.bfloat16)


# -- (a) the optimizer -------------------------------------------------
def test_two_sgd_updates_match_optax():
    kw = dict(TINY, block_impl="fused_pallas", stem="s2d")
    params, stats = draw_vision_trees(
        JR.ResNet50(num_classes=CLASSES, **kw), (1, IMAGE, IMAGE, 3), 3,
        {"train": False})
    step, _, state = TT.build_training(
        model_name="resnet50", image_size=IMAGE, num_classes=CLASSES,
        learning_rate=LR, model_kwargs=dict(kw, dtype=torch.float32),
        device="cpu", params=params, batch_stats=stats,
    )
    tx = JT.make_optimizer(LR)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    for i in range(2):
        images, labels = _batch(10 + i)
        state, _ = step(state, torch.from_numpy(images),
                        torch.from_numpy(labels))
        grads = jax.tree_util.tree_map(
            jnp.asarray, convert.to_flax_resnet_grads(state["model"]))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        got = _leaves(convert.to_flax_resnet(state["model"])[0])
        for key, want in _leaves(p).items():
            np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-6,
                                       err_msg=f"update {i}: {key}")
    assert state["step"] == 2


def test_decay_reaches_norm_parameters_not_running_statistics():
    opt = TT.make_optimizer([torch.nn.Parameter(torch.ones(3))])
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["nesterov"]
    model = TT.create_model("resnet18", CLASSES, device="cpu", **TINY)
    state = TT.create_train_state(torch.Generator().manual_seed(0), model)
    opt_params = {id(t) for g in state["opt"].param_groups
                  for t in g["params"]}
    assert {id(t) for t in model.parameters()} == opt_params
    assert not opt_params & {id(t) for t in model.buffers()}


# -- (b) three bf16 steps against the reference's builder --------------------
@pytest.mark.parametrize("block_impl,stem", [("fused_pallas", "s2d"),
                                             ("flax", "conv7")])
def test_bf16_builders_agree_for_three_steps(block_impl, stem):
    kw = dict(TINY, block_impl=block_impl, stem=stem)
    j_step, _, j_state = JT.build_training(
        model_name="resnet50", image_size=IMAGE, num_classes=CLASSES,
        learning_rate=LR, model_kwargs=kw,
    )
    params = jax.tree_util.tree_map(np.asarray, j_state["params"])
    stats = jax.tree_util.tree_map(np.asarray, j_state["batch_stats"])
    t_step, _, t_state = TT.build_training(
        model_name="resnet50", image_size=IMAGE, num_classes=CLASSES,
        learning_rate=LR, model_kwargs=kw, device="cpu", params=params,
        batch_stats=stats,
    )
    images, labels = _batch(4)
    j_losses, t_losses = [], []
    for _ in range(3):
        j_state, jl = j_step(j_state, jnp.asarray(images, jnp.bfloat16),
                             jnp.asarray(labels))
        t_state, tl = t_step(t_state, _port_images(images),
                             torch.from_numpy(labels))
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    assert t_losses[-1] < t_losses[0]  # it trains
    np.testing.assert_allclose(t_losses, j_losses, rtol=3e-2, atol=0)


# -- (c) the builders' contracts ---------------------------------------
def _tiny(builder, **kw):
    return builder(model_name="resnet18", image_size=IMAGE,
                   num_classes=CLASSES, model_kwargs=TINY, device="cpu", **kw)


def test_scan_training_runs_k_steps_on_device_batches():
    multi, state = _tiny(TT.build_scan_training, steps_per_call=3,
                         global_batch=BATCH)
    state, loss = multi(state, torch.Generator().manual_seed(0))
    assert state["step"] == 3 and np.isfinite(float(loss))


def test_bank_training_cycles_a_drawn_bank():
    multi, state, (images, labels) = _tiny(
        TT.build_bank_training, steps_per_call=3, global_batch=BATCH,
        bank_size=2)
    assert images.shape == (2, BATCH, IMAGE, IMAGE, 3)
    assert images.dtype == torch.bfloat16 and labels.shape == (2, BATCH)
    state, loss = multi(state, images, labels)
    assert state["step"] == 3 and np.isfinite(float(loss))


def test_synthetic_batch_is_drawn_from_the_generator():
    images, labels = TT.synthetic_batch(torch.Generator().manual_seed(1), 4,
                                        IMAGE, CLASSES)
    assert images.shape == (4, IMAGE, IMAGE, 3)
    assert images.dtype == torch.bfloat16
    assert int(labels.min()) >= 0 and int(labels.max()) < CLASSES
    again, _ = TT.synthetic_batch(torch.Generator().manual_seed(1), 4,
                                  IMAGE, CLASSES)
    assert torch.equal(images, again)


def test_pallas_loss_is_the_xla_loss_on_the_cpu():
    losses = {}
    for impl in ("xla", "pallas"):
        step, _, state = _tiny(TT.build_training, loss_impl=impl)
        images, labels = _batch(5)
        _, loss = step(state, _port_images(images), torch.from_numpy(labels))
        losses[impl] = float(loss)
    assert losses["pallas"] == pytest.approx(losses["xla"], rel=1e-5)


def test_unported_paths_raise_naming_their_items():
    # Inception-v3 is ported (models/inception.py), and a mesh (models/
    # train.py); every model and norm the reference trains under a mesh
    # builds there and takes the mesh's groups in each of its
    # BatchNorms (their global statistics: tests/test_torch_lm_parallel
    # .py), here on a one-rank group.
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        launch,
        mesh as M,
    )

    assert type(TT.create_model("inception_v3", device="cpu")).__name__ == (
        "InceptionV3")
    assert not dist.is_initialized()
    launch.one_rank_group("cpu")
    try:
        mesh = M.make_mesh()
        for name, kw, size in (
            ("inception_v3", None, 75),
            ("resnet50", dict(TINY, norm_impl="flax"), IMAGE),
            ("resnet50", dict(TINY, block_impl="fused_pallas", stem="s2d"),
             IMAGE),
        ):
            step, batch_fn, state = TT.build_training(
                mesh=mesh, model_name=name, image_size=size,
                num_classes=CLASSES, model_kwargs=kw, device="cpu")
            norms = [m for m in state["model"].modules()
                     if isinstance(m, TT.BATCH_NORMS)]
            assert norms and all(
                m.groups == tuple(M.world_groups(mesh)) for m in norms)
            images, labels = batch_fn(torch.Generator().manual_seed(0), 2)
            _, loss = step(state, images, labels)
            assert np.isfinite(float(loss)), name
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="loss_impl"):
        _tiny(TT.build_training, loss_impl="bogus")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.build_training(model_name="resnet18", model_kwargs=TINY)


# -- (d) the job -------------------------------------------------------
JOB = ["--image-size", "32", "--batch-per-chip", "2", "--train-steps", "3",
       "--log-every", "1"]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch."
         "resnet_main", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


@pytest.mark.parametrize("extra,steps", [([], [1, 2, 3]),
                                         (["--steps-per-call", "2"], [2])])
def test_tiny_cpu_run_logs_the_reference_lines(extra, steps, tmp_path):
    out = _run(*JOB, "--device", "cpu", "--profile-dir", str(tmp_path),
               *extra)
    assert out.returncode == 0, out.stderr
    assert "training resnet50 on 1 devices (cpu), global batch 2" in (
        out.stderr)
    logged = re.findall(
        r"step (\d+) loss ([0-9.]+) images/sec \d+ \(\d+/chip\)", out.stderr)
    assert [int(s) for s, _ in logged] == steps, out.stderr
    assert all(np.isfinite(float(v)) for _, v in logged)
    assert re.search(r"done: \d+ steps in [0-9.]+s, \d+ images/sec",
                     out.stderr)
    assert os.listdir(tmp_path), "no profiler trace written"


def test_model_dir_saves_a_checkpoint_after_the_last_step(tmp_path):
    out = _run(*JOB, "--device", "cpu", "--model-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    # The warm-up step trains too: 3 logged steps end at step 4.
    assert os.listdir(tmp_path) == ["checkpoint_4"]
    assert os.listdir(tmp_path / "checkpoint_4") == ["state.pt"]


def test_inception_v3_job_runs_at_a_small_image():
    out = _run("--model", "inception_v3", "--image-size", "75",
               "--batch-per-chip", "2", "--train-steps", "1",
               "--log-every", "1", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert re.search(r"step 1 loss [0-9.]+ images/sec", out.stderr)


def test_distributed_on_one_host_trains_without_init():
    out = _run(*JOB, "--device", "cpu", "--distributed")
    assert out.returncode == 0, out.stderr
    assert "single-host slice; skipping torch.distributed init" in (
        out.stderr)
    assert "training resnet50 on 1 devices (cpu), global batch 2" in (
        out.stderr)


def _spawned(monkeypatch, args, env=None):
    """resnet_main.main(args) on a host of two visible cards, with
    spawn_ranks recorded instead of run: (rc, the calls)."""
    from container_engine_accelerators_tpu_torch import _device, resnet_main
    from container_engine_accelerators_tpu_torch.parallel import launch

    calls = []
    monkeypatch.setattr(_device, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(launch, "spawn_ranks",
                        lambda *a, **kw: calls.append((a, kw)) or 0)
    for key in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
                "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    return resnet_main.main(list(args)), calls


def _one_host_of_two_cards(monkeypatch, flags):
    rc, calls = _spawned(monkeypatch, [*JOB, *flags])
    assert rc == 0
    assert len(calls) == 1
    (target, world, payload), kw = calls[0]
    assert target == ("container_engine_accelerators_tpu_torch.resnet_main"
                      ":rank_main")
    assert world == 2 and payload == ([*JOB, *flags], "cuda")
    assert kw == dict(device="cuda", cluster=None)


def test_distributed_refuses_several_visible_cards(monkeypatch):
    # No longer refused: --distributed on one host starts one rank per
    # visible card, as lm_main does.
    _one_host_of_two_cards(monkeypatch, ["--distributed"])


def test_two_visible_cards_start_two_ranks(monkeypatch):
    _one_host_of_two_cards(monkeypatch, [])


def test_distributed_across_hosts_passes_the_cluster(monkeypatch):
    rc, calls = _spawned(
        monkeypatch, [*JOB, "--distributed"],
        env={"TPU_WORKER_HOSTNAMES": "host-a,host-b", "TPU_WORKER_ID": "1"})
    assert rc == 0
    (_, world, _), kw = calls[0]
    assert world == 2  # this host's local ranks of 2 x 2
    assert kw == dict(device="cuda", cluster=("host-a:8476", 2, 1))


def test_ranks_flag_is_for_the_cpu(monkeypatch, caplog):
    import logging

    with caplog.at_level(logging.ERROR, logger="resnet_main"):
        rc, calls = _spawned(monkeypatch, [*JOB, "--ranks", "2"])
    assert rc == 2 and not calls
    assert "--ranks is for the CPU" in caplog.text


@pytest.mark.parametrize("model,image", [("resnet18", "32"),
                                         ("inception_v3", "75")])
def test_two_cpu_ranks_train_data_parallel(model, image):
    out = _run("--ranks", "2", "--device", "cpu", "--model", model,
               "--image-size", image, "--batch-per-chip", "1",
               "--train-steps", "2", "--log-every", "1")
    assert out.returncode == 0, out.stderr
    # Rank 0 alone logs.
    assert out.stderr.count(
        f"training {model} on 2 devices (cpu), global batch 2") == 1, (
        out.stderr)
    logged = re.findall(r"step (\d+) loss ([0-9.]+) images/sec \d+ "
                        r"\(\d+/chip\)", out.stderr)
    assert [int(s) for s, _ in logged] == [1, 2], out.stderr
    assert all(np.isfinite(float(v)) for _, v in logged)
    assert out.stderr.count("done: 2 steps") == 1


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    out = _run(*JOB)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
