"""ResNet and Inception-v3 training on one card: the port of
container_engine_accelerators_tpu/models/train.py (`create_model` :35,
`make_optimizer` :51, `create_train_state` :60, `synthetic_batch` :79,
`train_step` :91, `build_training` :179, `build_scan_training` :224,
`build_bank_training` :267), on one card or over a data-parallel mesh.

The model holds f32 parameters and running statistics and computes in
bf16 (models/resnet.py).  The optimizer is optax's chain of
add_decayed_weights(1e-4) and Nesterov SGD (momentum 0.9), which
torch.optim.SGD(nesterov=True, weight_decay=...) computes step for step:
the decay reaches every parameter (BatchNorm scales and biases too) and
never the running statistics, which are buffers.  A step runs the
forward, backward and update in place and leaves the step's gradients
on the parameters (`.grad`) until the next one.  Synthetic batches are
drawn on the device from an explicit torch.Generator; JAX's random
streams are not reproduced.  The reference's jit, donation and scan
have no counterpart here: the K steps of a scan are a Python loop.

Under a mesh (a DeviceMesh, parallel/mesh.py; this process one of its
ranks) the step takes the global batch, trains on this rank's share of
it (split over every mesh axis, as the reference's batch_sharding), and
sums the gradients over the mesh (parallel/layout.py `step_on_mesh`).
BatchNorm takes the global batch's statistics, as GSPMD gives flax's,
in every model and norm the reference trains under a mesh: the fused
norm (models/norm.py), flax's (resnet.py `BNAct`, Inception v3's
BatchNorm) and the fused block's folded norms (models/fused_block.py,
from the kernels' column sums) average their moments over the mesh's
groups (`BATCH_NORMS`), and each all-reduce's backward is its adjoint.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from ..ops.fused_xent import fused_cross_entropy_loss
from ..ops.losses import cross_entropy_loss
from . import inception, resnet
from .convert import load_flax_vision
from .fused_block import FusedBottleneckBlock
from .norm import FusedBatchNormAct

# Every module whose BatchNorm statistics reduce over the batch: under a
# mesh each takes the mesh's groups and the global batch's statistics.
BATCH_NORMS = (FusedBatchNormAct, resnet.BNAct, inception.BatchNorm,
               FusedBottleneckBlock)

FACTORIES = {
    "resnet18": resnet.ResNet18,
    "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50,
    "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
    "inception_v3": inception.InceptionV3,
}


def create_model(name: str = "resnet50", num_classes: int = 1000,
                 device="cuda", **kwargs):
    """kwargs pass through to the model factory (e.g. stem="s2d")."""
    return FACTORIES[name](num_classes=num_classes, device=device, **kwargs)


def make_optimizer(params, learning_rate: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """optax.chain(add_decayed_weights(weight_decay), sgd(learning_rate,
    momentum, nesterov=True)) over `params`."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           nesterov=True, weight_decay=weight_decay)


def create_train_state(generator: torch.Generator, model,
                       learning_rate: float = 0.1, params=None,
                       batch_stats=None) -> Dict[str, Any]:
    """{"model", "opt", "step"}: the model's parameters drawn from
    `generator` as flax's initializers draw them, or loaded from flax
    trees (params and batch_stats, numpy leaves), then made trainable."""
    if params is None:
        model.init_random(generator)
    else:
        load_flax_vision(model, params, batch_stats)
    model.requires_grad_(True)
    return {"model": model,
            "opt": make_optimizer(model.parameters(), learning_rate),
            "step": 0}


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    image_size: int = 224, num_classes: int = 1000):
    """A fake-ImageNet batch drawn on the generator's device: bf16 images
    (batch, size, size, 3) N(0, 1) and int64 labels in [0, classes)."""
    dev = generator.device
    images = torch.randn((batch_size, image_size, image_size, 3),
                         generator=generator, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, num_classes, (batch_size,),
                           generator=generator, device=dev)
    return images, labels


def train_step(state, images, labels, loss_impl: str = "xla"):
    """One SGD step in place: (state, loss).  loss_impl "xla" (torch's
    log_softmax) or "pallas" (the fused cross-entropy kernels)."""
    if loss_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    model, opt = state["model"], state["opt"]
    opt.zero_grad(set_to_none=True)
    logits = model(images, train=True)
    loss_of = (fused_cross_entropy_loss if loss_impl == "pallas"
               else cross_entropy_loss)
    loss = loss_of(logits, labels)
    loss.backward()
    opt.step()
    state["step"] += 1
    return state, loss.detach()


def _setup_training(model_name, num_classes, learning_rate, seed, loss_impl,
                    model_kwargs, mesh, device, params, batch_stats):
    if loss_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    dev = resolve_device(device)
    model = create_model(model_name, num_classes, device=dev,
                         **(model_kwargs or {}))
    state = create_train_state(torch.Generator().manual_seed(seed), model,
                               learning_rate, params, batch_stats)
    if mesh is None:
        def step_fn(state, images, labels):
            return train_step(state, images, labels, loss_impl)

        return state, step_fn, dev

    from ..parallel import layout as LY
    from ..parallel.mesh import batch_sharding, world_groups

    groups = world_groups(mesh)
    for m in model.modules():
        if isinstance(m, BATCH_NORMS):
            m.groups = tuple(groups)
    state.update(mesh=mesh, layout=LY.identity_layout(model, groups))
    take = batch_sharding(mesh)
    loss_of = (fused_cross_entropy_loss if loss_impl == "pallas"
               else cross_entropy_loss)

    def step_fn(state, images, labels):
        def loss_fn():
            logits = state["model"](take.shard(images), train=True)
            return loss_of(logits, take.shard(labels)), None

        loss, _ = LY.step_on_mesh(state, loss_fn)
        return state, loss

    return state, step_fn, dev


def build_training(mesh=None, model_name: str = "resnet50",
                   image_size: int = 224, num_classes: int = 1000,
                   learning_rate: float = 0.1, seed: int = 0,
                   loss_impl: str = "xla",
                   model_kwargs: Optional[Dict[str, Any]] = None, *,
                   device="cuda", params=None, batch_stats=None):
    """(step_fn, batch_fn, state): step_fn(state, images, labels) ->
    (state, loss); batch_fn(generator, batch_size) -> (images, labels)
    on the generator's device.  With a mesh, images and labels are the
    global batch and the loss its mean (module docstring).  params / batch_stats: flax trees to start
    from instead of the seeded draw.  Runs on the card unless
    device="cpu"."""
    state, step_fn, _ = _setup_training(
        model_name, num_classes, learning_rate, seed, loss_impl,
        model_kwargs, mesh, device, params, batch_stats,
    )

    def batch_fn(generator, batch_size):
        return synthetic_batch(generator, batch_size, image_size,
                               num_classes)

    return step_fn, batch_fn, state


def build_scan_training(mesh=None, model_name: str = "resnet50",
                        image_size: int = 224, num_classes: int = 1000,
                        learning_rate: float = 0.1, seed: int = 0,
                        loss_impl: str = "xla", steps_per_call: int = 10,
                        global_batch: int = 256,
                        model_kwargs: Optional[Dict[str, Any]] = None, *,
                        device="cuda", params=None, batch_stats=None):
    """(multi_step, state): multi_step(state, generator) runs
    `steps_per_call` steps, each on a batch drawn on the device from
    `generator`, and returns (state, the last step's loss)."""
    state, step_fn, _ = _setup_training(
        model_name, num_classes, learning_rate, seed, loss_impl,
        model_kwargs, mesh, device, params, batch_stats,
    )

    def multi_step(state, generator):
        loss = None
        for _ in range(steps_per_call):
            images, labels = synthetic_batch(generator, global_batch,
                                             image_size, num_classes)
            state, loss = step_fn(state, images, labels)
        return state, loss

    return multi_step, state


def build_bank_training(mesh=None, model_name: str = "resnet50",
                        image_size: int = 224, num_classes: int = 1000,
                        learning_rate: float = 0.1, seed: int = 0,
                        loss_impl: str = "xla", steps_per_call: int = 10,
                        global_batch: int = 256, bank_size: int = 2,
                        model_kwargs: Optional[Dict[str, Any]] = None, *,
                        device="cuda", params=None, batch_stats=None):
    """(multi_step, state, (images_bank, labels_bank)): `bank_size`
    batches drawn once on the device (from seed + 1); multi_step(state,
    images_bank, labels_bank) runs `steps_per_call` steps cycling
    through them and returns (state, the last step's loss)."""
    state, step_fn, dev = _setup_training(
        model_name, num_classes, learning_rate, seed, loss_impl,
        model_kwargs, mesh, device, params, batch_stats,
    )
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pairs = [synthetic_batch(gen, global_batch, image_size, num_classes)
             for _ in range(bank_size)]
    images_bank = torch.stack([p[0] for p in pairs])
    labels_bank = torch.stack([p[1] for p in pairs])

    def multi_step(state, images_bank, labels_bank):
        loss = None
        for i in range(steps_per_call):
            j = i % images_bank.shape[0]
            state, loss = step_fn(state, images_bank[j], labels_bank[j])
        return state, loss

    return multi_step, state, (images_bank, labels_bank)
