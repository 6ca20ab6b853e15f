"""Training checkpoints in a torch-native format: the port of
container_engine_accelerators_tpu/utils/checkpoint.py (`save_checkpoint`
:17, `latest_checkpoint` :28, `remap_resnet_norm_tree` :46,
`restore_params` :109, `restore_checkpoint` :155), keeping its contract:
`checkpoint_<step>/` directories under a model dir, the newest (highest
step) restored, names that do not parse skipped, and None where there is
nothing to restore.

The reference writes Orbax trees of its jax state; the port may import
neither, so a checkpoint directory holds one `state.pt` (torch.save) of
the port's train state: {"model": the module's state_dict (parameters
and buffers, such as BatchNorm's running statistics), "opt": the
optimizer's state_dict, "step": int}.  It is read with
torch.load(weights_only=True) onto the device of the state it is
restored into, so the restored tensors are bitwise the saved ones.
Crossing between the two formats goes through models/convert.py (flax
trees of numpy arrays), as the tests do.

A trainer over a mesh (a state with a "layout", parallel/layout.py)
saves and restores the same file: its ranks' pieces are put together on
rank 0 into the one-rank trainer's state, which rank 0 writes, and a
restore cuts that state into this rank's pieces, so a checkpoint written
at one world size restores at another, as the reference's Orbax trees
do.  Every rank calls save and restore.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def save_checkpoint(model_dir: str, state: Any, step: int) -> str:
    """Write `state` ({"model", "opt", "step"}) as checkpoint_<step>
    under model_dir; returns its path.  The file is written beside and
    renamed into place, so a reader never sees half of it."""
    path = os.path.join(os.path.abspath(model_dir), f"checkpoint_{step}")
    if "layout" in state:
        from ..parallel.layout import gather_state

        saved = gather_state(state)
        if saved is None:  # not rank 0
            return path
    else:
        saved = {"model": state["model"].state_dict(),
                 "opt": state["opt"].state_dict(),
                 "step": int(state["step"])}
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(saved, tmp)
    os.replace(tmp, target)
    log.info("saved checkpoint %s", path)
    return path


def latest_checkpoint(model_dir: str) -> Optional[str]:
    if not os.path.isdir(model_dir):
        return None
    steps = []
    for name in os.listdir(model_dir):
        if name.startswith("checkpoint_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(model_dir, max(steps)[1])


def _load(path: str, device) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                      map_location=device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _steps_where_kept(opt_state: dict) -> dict:
    """torch keeps the step count of an optimizer that is neither
    capturable nor fused on the CPU (reading it on the card would wait
    for the card each step); put the loaded counts back there."""
    for group in opt_state["param_groups"]:
        if group.get("capturable") or group.get("fused"):
            continue
        for i in group["params"]:
            st = opt_state["state"].get(i, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].cpu()
    return opt_state


_EXPLICIT_NORMS = frozenset({"norm_proj", "bn_init"})


def remap_resnet_norm_tree(tree: Any, to_impl: str) -> Any:
    """One-time migration of a ResNet params/batch_stats tree across the
    norm-module renaming (models/resnet.py norm_impl).

    Three layouts exist historically, all holding identical leaves
    (scale/bias in params, mean/var in batch_stats):

      pre-fused era:  .../BatchNorm_i, norm_proj, bn_init
      norm_impl=flax: .../_BNAct_i/BatchNorm_0, norm_proj/BatchNorm_0,
                      bn_init/BatchNorm_0
      norm_impl=fused (default): .../FusedBatchNormAct_i, norm_proj,
                      bn_init

    Checkpoints saved under one layout fail to restore under another
    (module auto-naming changed when the _BNAct/FusedBatchNormAct
    wrappers landed).  This remap renames module paths only — apply it
    to each collection of a restored raw tree, then resume:

        params = remap_resnet_norm_tree(params, "fused")

    to_impl: "fused" or "flax" — the layout of the model you are
    restoring INTO.  Detection is per-node, so mixed/already-converted
    trees pass through unchanged.
    """
    import re

    if to_impl not in ("fused", "flax"):
        raise ValueError(f"unknown norm layout {to_impl!r}")

    def is_leafy(node: Any) -> bool:
        return isinstance(node, dict) and not any(
            isinstance(v, dict) for v in node.values()
        )

    def to_fused(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            m = re.fullmatch(r"(?:BatchNorm|_BNAct|FusedBatchNormAct)_(\d+)", k)
            if m and isinstance(v, dict):
                inner = v.get("BatchNorm_0", v)
                out[f"FusedBatchNormAct_{m.group(1)}"] = to_fused(inner)
            elif (
                k in _EXPLICIT_NORMS
                and isinstance(v, dict)
                and set(v) == {"BatchNorm_0"}
            ):
                out[k] = v["BatchNorm_0"]
            else:
                out[k] = to_fused(v)
        return out

    def fused_to_flax(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            m = re.fullmatch(r"FusedBatchNormAct_(\d+)", k)
            if m and isinstance(v, dict):
                out[f"_BNAct_{m.group(1)}"] = {"BatchNorm_0": v}
            elif k in _EXPLICIT_NORMS and is_leafy(v):
                out[k] = {"BatchNorm_0": v}
            else:
                out[k] = fused_to_flax(v)
        return out

    fused = to_fused(tree)
    return fused if to_impl == "fused" else fused_to_flax(fused)


def restore_params(model_dir: str, model) -> Optional[Any]:
    """Load ONLY the parameters of the newest checkpoint into `model`
    (the serving-side loader: no optimizer state, no buffers); returns
    the model, or None when no checkpoint exists."""
    path = latest_checkpoint(model_dir)
    if path is None:
        return None
    saved = _load(path, _device(model))["model"]
    names = dict(model.named_parameters())
    missing = set(names) - set(saved)
    if missing:
        raise KeyError(f"checkpoint {path} lacks parameters {sorted(missing)}")
    with torch.no_grad():
        for name, param in names.items():
            param.copy_(saved[name])
    log.info("restored params from checkpoint %s", path)
    return model


def restore_checkpoint(model_dir: str, state: Any) -> Optional[Any]:
    """Load the newest checkpoint into `state` ({"model", "opt", "step"}:
    the module's parameters and buffers, the optimizer's state, the
    step) and return it; None when no checkpoint exists."""
    path = latest_checkpoint(model_dir)
    if path is None:
        return None
    if "layout" in state:
        from ..parallel.layout import scatter_state

        scatter_state(state, _load(path, "cpu"))
        log.info("restored checkpoint %s", path)
        return state
    saved = _load(path, _device(state["model"]))
    state["model"].load_state_dict(saved["model"])
    state["opt"].load_state_dict(_steps_where_kept(saved["opt"]))
    state["step"] = saved["step"]
    log.info("restored checkpoint %s", path)
    return state
