"""Where each rank's parameters sit in the one-rank model (port-only).

The reference keeps every array whole and lets a NamedSharding say
which device holds which piece, so an Orbax checkpoint written at one
world size restores at another.  The port's ranks hold only their
pieces; a `Layout` names, for each local parameter, the canonical
tensor it is a piece of (the parameter of the same family's one-rank
model), how that tensor is cut (viewed as `view`, split along `dim` into
`count` pieces, this rank's being `index`), and the process groups its
gradient is summed over (the axes it is replicated on).  gather_state
puts the canonical model and AdamW state together on rank 0, in the
one-rank trainer's own checkpoint format; scatter_state cuts a
canonical state back into any rank's pieces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Placement:
    canon: str
    shape: Tuple[int, ...]  # the canonical tensor's shape
    view: Optional[Tuple[int, ...]] = None
    dim: Optional[int] = None  # None: this rank holds it whole
    index: int = 0
    count: int = 1

    def cut(self, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self.dim is None or full.shape != torch.Size(self.shape):
            return full
        v = full.reshape(self.view or self.shape)
        return v.chunk(self.count, self.dim)[self.index].reshape(like.shape)

    def join(self, pieces: List[torch.Tensor]) -> torch.Tensor:
        view = list(self.view or self.shape)
        view[self.dim] //= self.count
        parts = [p.reshape(view) for p in pieces]
        return torch.cat(parts, self.dim).reshape(self.shape)


def split_placement(canon, shape, dim, index, count, view=None) -> Placement:
    return Placement(canon, tuple(shape), None if view is None else tuple(view),
                     dim, index, count)


def whole(canon, shape) -> Placement:
    return Placement(canon, tuple(shape))


@dataclass
class Layout:
    placements: Dict[str, Placement]  # local parameter name -> placement
    grad_groups: Dict[str, list]  # local parameter name -> process groups
    canon_order: List[str]  # the one-rank model's parameter order
    buffers: Dict[str, str] = field(default_factory=dict)  # local -> canon

    def grad_plan(self, model):
        return [(p, self.grad_groups[n]) for n, p in model.named_parameters()]


def identity_layout(model, groups) -> Layout:
    """Every parameter whole on every rank, its gradient summed over
    `groups`."""
    names = [n for n, _ in model.named_parameters()]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return Layout({n: whole(n, shapes[n]) for n in names},
                  {n: list(groups) for n in names}, names,
                  {n: n for n, _ in model.named_buffers()})


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_state(state) -> Optional[dict]:
    """{"model", "opt", "step"} of the canonical one-rank trainer on
    rank 0 (None on the others); every rank must call it."""
    model, opt, layout = state["model"], state["opt"], state["layout"]
    osd = opt.state_dict()
    order = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
    mine = {}
    for name, p in model.named_parameters():
        pl = layout.placements[name]
        st = osd["state"].get(order[id(p)], {})
        mine[pl.canon] = (pl, p.detach().cpu(),
                          {k: v.cpu() if torch.is_tensor(v) else v
                           for k, v in st.items()})
    bufs = {layout.buffers[n]: b.detach().cpu()
            for n, b in model.named_buffers()}
    if _world() > 1:
        box = [None] * _world() if dist.get_rank() == 0 else None
        dist.gather_object((mine, bufs), box, dst=0)
        if dist.get_rank() != 0:
            return None
    else:
        box = [(mine, bufs)]
    pieces: Dict[str, Dict[int, tuple]] = {}
    buffers = {}
    for m, b in box:
        buffers.update(b)
        for canon, (pl, t, st) in m.items():
            pieces.setdefault(canon, {})[pl.index] = (pl, t, st)
    model_sd, opt_state = {}, {}
    for i, canon in enumerate(layout.canon_order):
        parts = [pieces[canon][j] for j in sorted(pieces[canon])]
        pl = parts[0][0]
        if pl.dim is None:
            model_sd[canon], st = parts[0][1], parts[0][2]
        else:
            if len(parts) != pl.count:
                raise RuntimeError(f"{canon}: {len(parts)} of {pl.count} pieces")
            model_sd[canon] = pl.join([t for _, t, _ in parts])
            st = {}
            for k, v in parts[0][2].items():
                if torch.is_tensor(v) and v.shape == parts[0][1].shape:
                    st[k] = pl.join([p[2][k] for p in parts])
                else:
                    st[k] = v
        if st:
            opt_state[i] = st
    model_sd.update(buffers)
    group = {k: v for k, v in osd["param_groups"][0].items() if k != "params"}
    group["params"] = list(range(len(layout.canon_order)))
    return {"model": model_sd, "opt": {"state": opt_state,
                                       "param_groups": [group]},
            "step": int(state["step"])}


def scatter_state(state, saved: dict) -> None:
    """Load a canonical {"model", "opt", "step"} into this rank's
    pieces, in place."""
    model, opt, layout = state["model"], state["opt"], state["layout"]
    canon_index = {c: i for i, c in enumerate(layout.canon_order)}
    full, osd = saved["model"], saved["opt"]
    order = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
    local_state = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            pl = layout.placements[name]
            if tuple(full[pl.canon].shape) != pl.shape:
                raise ValueError(
                    f"checkpoint {pl.canon} is {tuple(full[pl.canon].shape)}, "
                    f"this model's {pl.shape}")
            p.copy_(pl.cut(full[pl.canon], p))
            st = osd["state"].get(canon_index[pl.canon])
            if st is not None:
                local_state[order[id(p)]] = {
                    k: pl.cut(v, p) if torch.is_tensor(v) and (
                        tuple(v.shape) == pl.shape) else v
                    for k, v in st.items()}
        for name, b in model.named_buffers():
            b.copy_(full[layout.buffers[name]])
    group = dict(osd["param_groups"][0])
    group["params"] = list(range(len(order)))
    opt.load_state_dict({"state": local_state, "param_groups": [group]})
    state["step"] = saved["step"]


def step_on_mesh(state, loss_fn):
    """One optimizer step of a mesh trainer, in place: loss_fn() gives
    (this rank's mean loss, extras); each rank backpropagates its share
    (the loss over the world size: the ranks' shares sum to the
    reference's global loss), sums each gradient over the axes its
    parameter is replicated on, and steps.  Returns (the global loss,
    extras)."""
    from . import _collectives as C
    from .mesh import world_groups

    model, opt, mesh = state["model"], state["opt"], state["mesh"]
    world = mesh.size()
    opt.zero_grad(set_to_none=True)
    loss, extras = loss_fn()
    (loss / world).backward()
    C.reduce_grads(state["layout"].grad_plan(model))
    opt.step()
    state["step"] += 1
    total = loss.detach().clone()
    for g in world_groups(mesh):
        dist.all_reduce(total, group=g)
    return total / world, extras
