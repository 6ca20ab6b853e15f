"""Inception v3 in PyTorch, NHWC: the port of
container_engine_accelerators_tpu/models/inception.py (`ConvBN` :22,
`InceptionA` :49 to `InceptionE` :126, `InceptionV3` :149), which has no
kernel of its own.

The numerics follow the flax modules as models/resnet.py's do:
parameters and BatchNorm statistics f32, activations NHWC in `dtype`
(bf16 by default), convolutions (models/resnet.py `Conv`: a torch
convolution on the channels_last NCHW view, flax's "SAME" pads) in
`dtype`, and the classifier head in f32.  Every ConvBN is a bias-free
conv, flax's nn.BatchNorm (momentum 0.9, epsilon 1e-3: resnet.py's
`BNAct` arithmetic) and a ReLU.  flax's avg_pool(3 x 3, stride 1,
"SAME") divides by the whole window, padding included
(count_include_pad=True); the max pools are "VALID".  The branches
concatenate on channels in the reference's order.

Every module carries flax's auto-name (`flax_name`: ConvBN_i in call
order inside each parent, Conv_0 / BatchNorm_0 inside a ConvBN), and
`flax_leaves` lists the params and batch_stats leaves, so
models/convert.py loads and reads flax trees as it does a ResNet's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .resnet import BNAct, Conv, _names, init_lecun, module_leaves

IMAGE_CHANNELS = 3


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum 0.9, epsilon 1e-3) then ReLU, with
    BNAct's arithmetic; its leaves sit directly under the ConvBN
    (BatchNorm_0), not one level down as BNAct's do."""

    flax_class = "BatchNorm"
    forward = BNAct.forward

    def __init__(self, features, dtype=torch.bfloat16):
        super().__init__()
        self.act, self.act_fn = True, torch.relu
        self.momentum, self.epsilon, self.dtype = 0.9, 1e-3, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.groups = ()  # a data-parallel mesh's axes: global statistics


class ConvBN(nn.Module):
    """inception.py `ConvBN`: a bias-free conv, BatchNorm and ReLU.
    padding "SAME" or "VALID"."""

    flax_class = "ConvBN"

    def __init__(self, c_in, features, kernel, strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        if padding == "VALID":
            padding = ((0, 0), (0, 0))
        self.conv = Conv(c_in, features, kernel, strides, padding, dtype)
        self.conv.flax_name = "Conv_0"
        self.bn = BatchNorm(features, dtype)
        self.bn.flax_name = "BatchNorm_0"

    def forward(self, x, train=True):
        return self.bn(self.conv(x), train)


def _nchw(fn, x, *args, **kw):
    """A torch NCHW pool on an NHWC activation (as a channels_last view)."""
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def avg_pool_same(x):
    """flax avg_pool((3, 3), strides=(1, 1), padding="SAME")."""
    return _nchw(F.avg_pool2d, x, 3, 1, 1, count_include_pad=True)


def max_pool_valid(x):
    """flax max_pool((3, 3), strides=(2, 2), padding="VALID")."""
    return _nchw(F.max_pool2d, x, 3, 2)


class _Block(nn.Module):
    """A parent that names its ConvBNs as flax does (ConvBN_i in the
    order the reference calls them)."""

    def __init__(self, dtype):
        super().__init__()
        self._name = _names()
        self.dtype = dtype

    def conv(self, c_in, features, kernel, strides=(1, 1), padding="SAME"):
        mod = ConvBN(c_in, features, kernel, strides, padding, self.dtype)
        mod.flax_name = self._name("ConvBN")
        return mod


class InceptionA(_Block):
    flax_class = "InceptionA"

    def __init__(self, c_in, pool_features, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b1 = self.conv(c_in, 64, (1, 1))
        self.b5 = nn.ModuleList([self.conv(c_in, 48, (1, 1)),
                                 self.conv(48, 64, (5, 5))])
        self.b3 = nn.ModuleList([self.conv(c_in, 64, (1, 1)),
                                 self.conv(64, 96, (3, 3)),
                                 self.conv(96, 96, (3, 3))])
        self.bp = self.conv(c_in, pool_features, (1, 1))
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x, train=True):
        b1 = self.b1(x, train)
        b5 = _chain(self.b5, x, train)
        b3 = _chain(self.b3, x, train)
        bp = self.bp(avg_pool_same(x), train)
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(_Block):
    flax_class = "InceptionB"

    def __init__(self, c_in, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b3 = self.conv(c_in, 384, (3, 3), (2, 2), "VALID")
        self.bd = nn.ModuleList([
            self.conv(c_in, 64, (1, 1)), self.conv(64, 96, (3, 3)),
            self.conv(96, 96, (3, 3), (2, 2), "VALID")])
        self.out_channels = 384 + 96 + c_in

    def forward(self, x, train=True):
        b3 = self.b3(x, train)
        bd = _chain(self.bd, x, train)
        return torch.cat([b3, bd, max_pool_valid(x)], dim=-1)


class InceptionC(_Block):
    flax_class = "InceptionC"

    def __init__(self, c_in, channels_7x7, dtype=torch.bfloat16):
        super().__init__(dtype)
        c7 = channels_7x7
        self.b1 = self.conv(c_in, 192, (1, 1))
        self.b7 = nn.ModuleList([
            self.conv(c_in, c7, (1, 1)), self.conv(c7, c7, (1, 7)),
            self.conv(c7, 192, (7, 1))])
        self.bd = nn.ModuleList([
            self.conv(c_in, c7, (1, 1)), self.conv(c7, c7, (7, 1)),
            self.conv(c7, c7, (1, 7)), self.conv(c7, c7, (7, 1)),
            self.conv(c7, 192, (1, 7))])
        self.bp = self.conv(c_in, 192, (1, 1))
        self.out_channels = 4 * 192

    def forward(self, x, train=True):
        b1 = self.b1(x, train)
        b7 = _chain(self.b7, x, train)
        bd = _chain(self.bd, x, train)
        bp = self.bp(avg_pool_same(x), train)
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(_Block):
    flax_class = "InceptionD"

    def __init__(self, c_in, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b3 = nn.ModuleList([
            self.conv(c_in, 192, (1, 1)),
            self.conv(192, 320, (3, 3), (2, 2), "VALID")])
        self.b7 = nn.ModuleList([
            self.conv(c_in, 192, (1, 1)), self.conv(192, 192, (1, 7)),
            self.conv(192, 192, (7, 1)),
            self.conv(192, 192, (3, 3), (2, 2), "VALID")])
        self.out_channels = 320 + 192 + c_in

    def forward(self, x, train=True):
        b3 = _chain(self.b3, x, train)
        b7 = _chain(self.b7, x, train)
        return torch.cat([b3, b7, max_pool_valid(x)], dim=-1)


class InceptionE(_Block):
    flax_class = "InceptionE"

    def __init__(self, c_in, dtype=torch.bfloat16):
        super().__init__(dtype)
        # Built in the reference's call order, so the ConvBN numbers match.
        self.b1 = self.conv(c_in, 320, (1, 1))
        self.b3 = self.conv(c_in, 384, (1, 1))
        self.b3a = self.conv(384, 384, (1, 3))
        self.b3b = self.conv(384, 384, (3, 1))
        self.bd = nn.ModuleList([self.conv(c_in, 448, (1, 1)),
                                 self.conv(448, 384, (3, 3))])
        self.bda = self.conv(384, 384, (1, 3))
        self.bdb = self.conv(384, 384, (3, 1))
        self.bp = self.conv(c_in, 192, (1, 1))
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, train=True):
        b1 = self.b1(x, train)
        b3 = self.b3(x, train)
        b3 = torch.cat([self.b3a(b3, train), self.b3b(b3, train)], dim=-1)
        bd = _chain(self.bd, x, train)
        bd = torch.cat([self.bda(bd, train), self.bdb(bd, train)], dim=-1)
        bp = self.bp(avg_pool_same(x), train)
        return torch.cat([b1, b3, bd, bp], dim=-1)


def _chain(mods, x, train):
    for mod in mods:
        x = mod(x, train)
    return x


class InceptionV3(nn.Module):
    """Inception v3 without the auxiliary head (as the reference):
    stem, 3 x A, B, 4 x C, D, 2 x E, global mean, f32 head.
    forward(x, train=True): x (N, H, W, 3), H and W at least 75 ->
    logits (N, num_classes) f32; train uses batch statistics and
    updates the running ones.  Kernels are zeros until loaded
    (models/convert.py) or drawn (`init_random`)."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes, self.dtype = num_classes, dtype
        name = _names()

        def conv(c_in, features, kernel, strides=(1, 1), padding="SAME"):
            mod = ConvBN(c_in, features, kernel, strides, padding, dtype)
            mod.flax_name = name("ConvBN")
            return mod

        def block(mod):
            mod.flax_name = name(mod.flax_class)
            return mod

        self.stem = nn.ModuleList([
            conv(IMAGE_CHANNELS, 32, (3, 3), (2, 2), "VALID"),
            conv(32, 32, (3, 3), padding="VALID"),
            conv(32, 64, (3, 3)),
            conv(64, 80, (1, 1), padding="VALID"),
            conv(80, 192, (3, 3), padding="VALID"),
        ])
        blocks, c = [], 192
        for pool in (32, 64, 64):
            blocks.append(block(InceptionA(c, pool, dtype)))
            c = blocks[-1].out_channels
        blocks.append(block(InceptionB(c, dtype)))
        c = blocks[-1].out_channels
        for c7 in (128, 160, 160, 192):
            blocks.append(block(InceptionC(c, c7, dtype)))
            c = blocks[-1].out_channels
        blocks.append(block(InceptionD(c, dtype)))
        c = blocks[-1].out_channels
        for _ in range(2):
            blocks.append(block(InceptionE(c, dtype)))
            c = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head_kernel = nn.Parameter(torch.zeros((c, num_classes)))
        self.head_bias = nn.Parameter(torch.zeros(num_classes))
        self.to(dev)

    def forward(self, x, train=True):
        x = x.to(self.dtype)
        s = self.stem
        x = s[2](s[1](s[0](x, train), train), train)
        x = max_pool_valid(x)
        x = max_pool_valid(s[4](s[3](x, train), train))
        for blk in self.blocks:
            x = blk(x, train)
        x = x.float().mean((1, 2)).to(self.dtype)
        return torch.matmul(x.float(), self.head_kernel) + self.head_bias

    def init_random(self, generator: torch.Generator):
        """Draw the kernels as flax's lecun_normal does
        (resnet.init_lecun); norm scales 1 and biases 0 as built."""
        init_lecun(flax_leaves(self), generator)
        return self


def flax_leaves(model):
    """(collection, flax path, tensor, layout) of every leaf of a port
    InceptionV3's flax `params` and `batch_stats` trees."""
    out = [("params", ("head", "kernel"), model.head_kernel, None),
           ("params", ("head", "bias"), model.head_bias, None)]
    for child in (*model.stem, *model.blocks):
        out += module_leaves(child, (child.flax_name,))
    return out

