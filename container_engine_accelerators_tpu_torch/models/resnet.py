"""ResNet v1.5 in PyTorch, NHWC: the port of
container_engine_accelerators_tpu/models/resnet.py (`Conv1x1` :26,
`ResNetBlock` :61, `BottleneckResNetBlock` :91, `_BNAct` :126,
`space_to_depth` :150, `ResNet` :162, the factories :280-294).

The numerics follow the flax modules: parameters and BatchNorm
statistics are f32, activations NHWC in `dtype` (bf16 by default),
convolutions compute in `dtype`, the classifier head in f32.
Convolutions run as torch convolutions on a channels_last NCHW view of
the NHWC activation, so no layout copy is made around them; flax's
"SAME" padding is asymmetric where the total is odd (a 3x3 stride-2
conv on an even input pads (0, 1), the s2d stem's 4x4 stride-1 conv (1,
2)), so such pads are explicit.  Conv kernels are stored as torch's
OIHW (flax: HWIO); the matmul-form kernels (Conv1x1, the fused block's
conv1 / conv3) keep flax's shapes.  BatchNorm is flax's, written out:
"fused" and "fused_y" take models/norm.py's FusedBatchNormAct, "flax"
takes `BNAct` (flax's nn.BatchNorm: fast variance clamped at 0, EMA
momentum 0.9 on the old value).  block_impl="fused_pallas" swaps the
bottleneck block for models/fused_block.py's kernel block.
remat="block" recomputes each block in the backward
(torch.utils.checkpoint); the recomputation restores the running
statistics it re-updates, so each step moves them once, as flax's
mutable collection does.

Every module carries flax's name for itself (`flax_name`, given as the
flax modules auto-name their children), and `flax_leaves` lists the
trees' leaves, so models/convert.py can load and read flax trees.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.fused_linear import dot_f32
from .fused_block import FusedBottleneckBlock
from .norm import FusedBatchNormAct, batch_stats

IMAGE_CHANNELS = 3  # RGB: the stem's input channels

def same_pads(size, kernel, stride):
    """flax / XLA "SAME" padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv(use_bias=False) computing in `dtype`, NHWC in and out.
    `kernel` is (out, in, kh, kw) f32; padding "SAME" or explicit
    ((lo, hi), (lo, hi))."""

    flax_class = "Conv"

    def __init__(self, c_in, c_out, kernel, strides=(1, 1), padding="SAME",
                 dtype=torch.bfloat16):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = nn.Parameter(torch.zeros((c_out, c_in, *kernel)))

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding == "SAME":
            pads = [same_pads(x.shape[1 + i], self.kernel_size[i],
                              self.strides[i]) for i in range(2)]
        else:
            pads = [tuple(p) for p in self.padding]
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            (ht, hb), (wl, wr) = pads
            x = F.pad(x, (0, 0, wl, wr, ht, hb))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(self.dtype),
                     stride=self.strides,
                     padding=(pads[0][0], pads[1][0]) if sym else 0)
        return y.permute(0, 2, 3, 1)


class Conv1x1(nn.Module):
    """A 1x1 convolution as a matmul (resnet.py Conv1x1): strides fold as
    a spatial slice, the product sums in f32 and rounds to `dtype`.
    `kernel` keeps flax's (1, 1, in, out)."""

    flax_class = "Conv1x1"

    def __init__(self, c_in, features, strides=(1, 1),
                 dtype=torch.bfloat16):
        super().__init__()
        self.features, self.strides, self.dtype = features, strides, dtype
        self.kernel = nn.Parameter(torch.zeros((1, 1, c_in, features)))

    def forward(self, x):
        c = x.shape[-1]
        if tuple(self.strides) != (1, 1):
            x = x[:, ::self.strides[0], ::self.strides[1], :]
        n, h, w, _ = x.shape
        y = dot_f32(x.reshape(n * h * w, c).to(self.dtype),
                    self.kernel.reshape(c, self.features).to(self.dtype))
        return y.to(self.dtype).reshape(n, h, w, self.features)


class BNAct(nn.Module):
    """resnet.py `_BNAct`: flax's nn.BatchNorm (statistics in f32, the
    variance E[x^2] - E[x]^2 clamped at 0, EMA momentum on the old value)
    then the activation if `act`.  Its parameters sit one level down in
    flax's tree (BatchNorm_0).  Under a data-parallel mesh `groups` are
    the mesh's axes and the statistics the global batch's, as GSPMD
    gives flax's (models/norm.py `batch_stats`)."""

    flax_class = "_BNAct"

    def __init__(self, features, act=False, act_fn=torch.relu, momentum=0.9,
                 epsilon=1e-5, dtype=torch.bfloat16, zero_scale=False):
        super().__init__()
        self.act, self.act_fn = act, act_fn
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.groups = ()  # a data-parallel mesh's axes: global statistics

    def forward(self, x, train=True):
        if train:
            mean, var = batch_stats(x, self.groups)
            var = torch.clamp(var, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * (torch.rsqrt(var + self.epsilon)
                                  * self.scale) + self.bias
        y = y.to(self.dtype)
        return self.act_fn(y) if self.act else y


def _names():
    """flax's auto-naming inside one parent: ClassName_i per class, in
    creation order; explicitly named children take no number."""
    counts = {}

    def name(cls_name, explicit=None):
        if explicit is not None:
            return explicit
        i = counts.get(cls_name, 0)
        counts[cls_name] = i + 1
        return f"{cls_name}_{i}"

    return name


class ResNetBlock(nn.Module):
    """Basic ResNet block (ResNet-18/34)."""

    flax_class = "ResNetBlock"

    def __init__(self, c_in, filters, conv, norm, act=torch.relu,
                 strides=(1, 1), conv1x1=None):
        super().__init__()
        self.act = act
        self.conv_0 = conv(c_in, filters, (3, 3), strides)
        self.norm_0 = norm(filters, act=True)
        self.conv_1 = conv(filters, filters, (3, 3))
        self.norm_1 = norm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or c_in != filters:
            if conv1x1 is not None:
                self.conv_proj = conv1x1(c_in, filters, strides,
                                         name="conv_proj")
            else:
                self.conv_proj = conv(c_in, filters, (1, 1), strides,
                                      name="conv_proj")
            self.norm_proj = norm(filters, name="norm_proj")

    def forward(self, x, train):
        y = self.norm_0(self.conv_0(x), train)
        y = self.norm_1(self.conv_1(y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return self.act(residual + y)


class BottleneckResNetBlock(nn.Module):
    """Bottleneck block (ResNet-50/101/152); `conv1x1` is the matmul 1x1
    factory or None for (1, 1) convolutions."""

    flax_class = "BottleneckResNetBlock"

    def __init__(self, c_in, filters, conv, norm, act=torch.relu,
                 strides=(1, 1), conv1x1=None):
        super().__init__()

        def c1(ci, co, s=(1, 1), name=None):
            if conv1x1 is not None:
                return conv1x1(ci, co, s, name=name)
            return conv(ci, co, (1, 1), s, name=name)

        self.act = act
        self.conv_0 = c1(c_in, filters)
        self.norm_0 = norm(filters, act=True)
        self.conv_1 = conv(filters, filters, (3, 3), strides)
        self.norm_1 = norm(filters, act=True)
        self.conv_2 = c1(filters, 4 * filters)
        self.norm_2 = norm(4 * filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or c_in != 4 * filters:
            self.conv_proj = c1(c_in, 4 * filters, strides, name="conv_proj")
            self.norm_proj = norm(4 * filters, name="norm_proj")

    def forward(self, x, train):
        y = self.norm_0(self.conv_0(x), train)
        y = self.norm_1(self.conv_1(y), train)
        y = self.norm_2(self.conv_2(y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return self.act(residual + y)


def space_to_depth(x, block=2):
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C): fold b x b spatial blocks
    into channels (the s2d stem's transform)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


class _Named:
    """Module factories that name what they build as flax names it."""

    def __init__(self, name_fn, build):
        self.name_fn, self.build = name_fn, build

    def __call__(self, *args, name=None, **kw):
        mod = self.build(*args, **kw)
        mod.flax_name = self.name_fn(mod.flax_class, name)
        return mod


@contextlib.contextmanager
def _restored_buffers(module):
    """Run the block, then put its buffers (the running statistics) back:
    the recomputation of a checkpointed block must not move them again."""
    saved = [b.detach().clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


class ResNet(nn.Module):
    """ResNet v1.5 with a configurable stage layout, NHWC.

    stem: "conv7" (7x7/2) or "s2d" (space-to-depth 2x2 fold + 4x4/1
    conv); conv1x1: "conv" or "dot" (Conv1x1); norm_impl: "fused",
    "fused_y" or "flax"; block_impl: "flax" or "fused_pallas" (the
    kernel block, for bottleneck models); remat: "none" or "block".
    forward(x, train=True): x (N, H, W, 3) -> logits (N,
    num_classes) f32; train uses batch statistics and updates the
    running ones.  Parameters are zeros until loaded
    (models/convert.py) or drawn (`init_random`)."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, act=torch.relu,
                 stem="conv7", conv1x1="conv", norm_impl="fused",
                 block_impl="flax", remat="none", device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if norm_impl in ("fused", "fused_y") and act is not torch.relu:
            # The fused norm's backward bakes the ReLU mask in.
            raise ValueError(
                "norm_impl='fused' supports act=relu only; use "
                "norm_impl='flax' for custom activations"
            )
        if norm_impl not in ("fused", "fused_y", "flax"):
            raise ValueError(f"unknown norm_impl {norm_impl!r}")
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}")
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        if conv1x1 not in ("conv", "dot"):
            raise ValueError(f"unknown conv1x1 {conv1x1!r}")
        self.stage_sizes, self.num_classes = list(stage_sizes), num_classes
        self.dtype, self.act, self.stem = dtype, act, stem
        self.remat = remat
        fused = norm_impl in ("fused", "fused_y")
        # momentum 0.9 and epsilon 1e-5: the norms' defaults, as the
        # reference's ResNet sets them.

        def scope():
            name = _names()
            conv = _Named(name, lambda ci, co, k, s=(1, 1), padding="SAME":
                          Conv(ci, co, k, s, padding, dtype))
            c1x1 = _Named(name, lambda ci, co, s=(1, 1):
                          Conv1x1(ci, co, s, dtype))
            if fused:
                residual = "y" if norm_impl == "fused_y" else "xhat"
                norm = _Named(name, lambda f, act=False, zero_scale=False:
                              FusedBatchNormAct(f, act, dtype=dtype,
                                                zero_scale=zero_scale,
                                                residual=residual))
            else:
                norm = _Named(name, lambda f, act=False, zero_scale=False:
                              BNAct(f, act, self.act, dtype=dtype,
                                    zero_scale=zero_scale))
            return name, conv, (c1x1 if conv1x1 == "dot" else None), norm

        name, conv, _, norm = scope()
        if stem == "s2d":
            self.conv_init = conv(4 * IMAGE_CHANNELS, num_filters, (4, 4),
                                  name="conv_init")
        else:
            self.conv_init = conv(IMAGE_CHANNELS, num_filters, (7, 7), (2, 2),
                                  padding=((3, 3), (3, 3)), name="conv_init")
        self.bn_init = norm(num_filters, act=True, name="bn_init")
        if block_impl == "fused_pallas" and block_cls is BottleneckResNetBlock:
            block_cls = FusedBottleneckBlock
        prefix = "Checkpoint" if remat == "block" else ""
        self.blocks = nn.ModuleList()
        c_in = num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                _, b_conv, b_c1x1, b_norm = scope()
                blk = block_cls(
                    c_in, num_filters * 2 ** i, conv=b_conv, norm=b_norm,
                    act=act, strides=strides, conv1x1=b_c1x1,
                )
                blk.flax_name = name(prefix + blk.flax_class)
                self.blocks.append(blk)
                c_in = num_filters * 2 ** i * (
                    4 if block_cls is not ResNetBlock else 1)
        self.head_kernel = nn.Parameter(torch.zeros((c_in, num_classes)))
        self.head_bias = nn.Parameter(torch.zeros(num_classes))
        self.to(dev)

    def forward(self, x, train=True):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = self.bn_init(self.conv_init(x), train)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for blk in self.blocks:
            if self.remat == "block" and torch.is_grad_enabled():
                x = checkpoint(
                    blk, x, train, use_reentrant=False,
                    context_fn=lambda blk=blk: (contextlib.nullcontext(),
                                                _restored_buffers(blk)),
                )
            else:
                x = blk(x, train)
        x = x.float().mean((1, 2)).to(self.dtype)
        return torch.matmul(x.float(), self.head_kernel) + self.head_bias

    def init_random(self, generator: torch.Generator):
        """Draw the parameters as flax's initializers do, from
        `generator` (init_lecun); norm scales 1 (the blocks' last norm
        0) and biases 0 as built."""
        init_lecun(flax_leaves(self), generator)
        return self


def init_lecun(leaves, generator: torch.Generator):
    """Draw every conv and dense kernel of `leaves` (flax_leaves) as
    flax's lecun_normal does: a normal of variance 1 / fan_in truncated
    at 2 sigma, from `generator`.  Drawn on the CPU in f32, then moved,
    so a seed gives the same weights on every device."""

    def lecun(shape, fan_in):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        w = torch.empty(shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w * std

    with torch.no_grad():
        for _, path, t, layout in leaves:
            if path[-1] == "kernel" or path[-1].endswith("_kernel"):
                fan_in = (t.numel() // t.shape[0] if layout == "oihw"
                          else t.numel() // t.shape[-1])
                t.copy_(lecun(tuple(t.shape), fan_in))


def module_leaves(mod, prefix=()):
    """(collection, flax path, tensor, layout) for every leaf of the flax
    `params` and `batch_stats` trees of one port module and its children,
    paths under `prefix`.  layout "oihw" marks a conv kernel that flax
    stores HWIO."""
    if isinstance(mod, (Conv, Conv1x1)):
        return [("params", prefix + ("kernel",), mod.kernel,
                 "oihw" if isinstance(mod, Conv) else None)]
    if isinstance(mod, (FusedBatchNormAct, BNAct)):
        p = prefix + (("BatchNorm_0",) if isinstance(mod, BNAct) else ())
        return [("params", p + ("scale",), mod.scale, None),
                ("params", p + ("bias",), mod.bias, None),
                ("batch_stats", p + ("mean",), mod.mean, None),
                ("batch_stats", p + ("var",), mod.var, None)]
    out = [("params", prefix + (name,), t, None)
           for name, t in mod.named_parameters(recurse=False)]
    out += [("batch_stats", prefix + (name,), t, None)
            for name, t in mod.named_buffers(recurse=False)]
    for child in mod.children():
        if isinstance(child, nn.ModuleList):  # a list takes no flax name
            out += module_leaves(child, prefix)
        else:
            out += module_leaves(child, prefix + (child.flax_name,))
    return out


def flax_leaves(model):
    """module_leaves of a whole port ResNet: the stem, its norm, every
    block and the head."""
    out = [("params", ("head", "kernel"), model.head_kernel, None),
           ("params", ("head", "bias"), model.head_bias, None)]
    for child in (model.conv_init, model.bn_init, *model.blocks):
        out += module_leaves(child, (child.flax_name,))
    return out


ResNet18 = functools.partial(
    ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock
)
ResNet34 = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock
)
ResNet50 = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckResNetBlock
)
ResNet101 = functools.partial(
    ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckResNetBlock
)
ResNet152 = functools.partial(
    ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckResNetBlock
)
