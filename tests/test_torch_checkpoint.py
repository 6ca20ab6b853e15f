"""The port's checkpoints (container_engine_accelerators_tpu_torch/utils/
checkpoint.py) against the reference's contract (container_engine_
accelerators_tpu/utils/checkpoint.py): `latest_checkpoint` on the same
directory listings and `remap_resnet_norm_tree` on the same trees give
the reference's answers; a run that saves, is rebuilt from another seed,
restores and steps on equals, bitwise on the CPU, a run that never
stopped (the LM trainer with AdamW, the ResNet trainer with Nesterov
SGD and BatchNorm's running statistics); the restored tensors are the
saved ones bit for bit; restore_params loads parameters only; and an
empty or missing model dir restores nothing."""

import os

import pytest
import torch

from container_engine_accelerators_tpu.utils import checkpoint as JC
from container_engine_accelerators_tpu_torch.models import train as TT
from container_engine_accelerators_tpu_torch.models import transformer as PT
from container_engine_accelerators_tpu_torch.utils import checkpoint as TC

LM = dict(vocab=64, dim=32, depth=2, heads=2, seq_len=32, batch=2,
          learning_rate=1e-2, device="cpu", dtype=torch.float32)
RESNET = dict(model_name="resnet18", image_size=16, num_classes=4,
              model_kwargs=dict(stage_sizes=[1, 1], num_filters=8,
                                dtype=torch.float32), device="cpu")


@pytest.mark.parametrize("names", [
    [],
    ["checkpoint_3", "checkpoint_10", "checkpoint_9"],
    ["checkpoint_x", "checkpoint_", "notes", "checkpoint_2"],
    ["checkpoint_5_old", "checkpoint_-4", "checkpoint_1"],
    ["checkpoint_x", "other"],
])
def test_latest_checkpoint_matches_reference(tmp_path, names):
    for name in names:
        os.makedirs(tmp_path / name)
    assert TC.latest_checkpoint(str(tmp_path)) == JC.latest_checkpoint(
        str(tmp_path))
    missing = str(tmp_path / "missing")
    assert TC.latest_checkpoint(missing) is JC.latest_checkpoint(missing)


_LEAF = {"scale": 1.0, "bias": 0.0}
TREES = [
    {"BatchNorm_0": dict(_LEAF), "bn_init": dict(_LEAF),
     "block": {"BatchNorm_2": dict(_LEAF), "Conv_0": {"kernel": 1.0}}},
    {"_BNAct_1": {"BatchNorm_0": dict(_LEAF)},
     "norm_proj": {"BatchNorm_0": dict(_LEAF)},
     "bn_init": {"BatchNorm_0": dict(_LEAF)}},
    {"FusedBatchNormAct_0": dict(_LEAF), "norm_proj": dict(_LEAF),
     "head": {"kernel": 2.0}},
]


@pytest.mark.parametrize("to_impl", ["fused", "flax"])
@pytest.mark.parametrize("tree", range(len(TREES)))
def test_remap_resnet_norm_tree_matches_reference(tree, to_impl):
    assert TC.remap_resnet_norm_tree(TREES[tree], to_impl) == (
        JC.remap_resnet_norm_tree(TREES[tree], to_impl))
    with pytest.raises(ValueError, match="unknown norm layout"):
        TC.remap_resnet_norm_tree(TREES[tree], "batch")


def _lm(seed):
    step, state, batch_fn = PT.build_lm_training(seed=seed, **LM)
    return step, state, batch_fn(torch.Generator().manual_seed(7))


def _resnet(seed):
    step, batch_fn, state = TT.build_training(seed=seed, **RESNET)
    return step, state, batch_fn(torch.Generator().manual_seed(7), 4)


def _snapshot(state):
    model = {k: v.clone() for k, v in state["model"].state_dict().items()}
    opt = [{k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
           for s in state["opt"].state.values()]
    return model, opt


def _equal(a, b):
    (ma, oa), (mb, ob) = a, b
    return ma.keys() == mb.keys() and all(
        torch.equal(ma[k], mb[k]) for k in ma) and len(oa) == len(ob) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(oa, ob))


@pytest.mark.parametrize("build", [_lm, _resnet], ids=["lm", "resnet"])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, build):
    step, state, batch = build(0)
    whole = []
    for _ in range(4):
        state, loss = step(state, *batch)
        whole.append(float(loss))
    end = _snapshot(state)

    step, state, batch = build(0)
    resumed = []
    for _ in range(2):
        state, loss = step(state, *batch)
        resumed.append(float(loss))
    saved = _snapshot(state)
    path = TC.save_checkpoint(str(tmp_path), state, state["step"])
    assert path == os.path.join(str(tmp_path), "checkpoint_2")

    step, state, batch = build(1)  # other weights until restored
    assert not _equal(_snapshot(state), saved)
    assert TC.restore_checkpoint(str(tmp_path), state) is state
    assert state["step"] == 2 and _equal(_snapshot(state), saved)
    for _ in range(2):
        state, loss = step(state, *batch)
        resumed.append(float(loss))
    assert resumed == whole and state["step"] == 4
    assert _equal(_snapshot(state), end)


def test_restore_params_loads_parameters_only(tmp_path):
    step, state, batch = _resnet(0)
    state, _ = step(state, *batch)
    TC.save_checkpoint(str(tmp_path), state, 1)
    TC.save_checkpoint(str(tmp_path), {**state, "step": 0}, 0)
    model = TT.create_model("resnet18", 4, device="cpu",
                            **RESNET["model_kwargs"])
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    assert TC.restore_params(str(tmp_path), model) is model
    for (name, got), want in zip(model.named_parameters(),
                                 state["model"].parameters()):
        assert torch.equal(got, want), name
    for name, got in model.named_buffers():
        assert torch.equal(got, buffers[name]), name


def test_empty_or_missing_model_dir_restores_nothing(tmp_path):
    _, state, _ = _lm(0)
    before = _snapshot(state)
    for model_dir in (str(tmp_path), str(tmp_path / "missing")):
        assert TC.restore_checkpoint(model_dir, state) is None
        assert TC.restore_params(model_dir, state["model"]) is None
    assert state["step"] == 0 and _equal(_snapshot(state), before)
