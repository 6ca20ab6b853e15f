"""Fused ResNet bottleneck block: the 1x1 convs as the fused-matmul kernel
(ops/fused_linear.py) with BatchNorm folded in.  The port of
container_engine_accelerators_tpu/models/fused_block.py (`_BNState` :44,
`FusedBottleneckBlock` :79).

In training the first 1x1 conv's matmul yields its output's column sum
and sum of squares, so bn1's statistics need no pass over y1; bn2's
normalize + ReLU is applied to conv3's operand as the kernel reads it,
so z2 never exists in memory, and conv3's epilogue yields bn3's
statistics.  The 3x3 conv stays a torch convolution (the reference's
XLA conv), and its statistics a torch reduction.  Gradients flow through
the statistics (the kernels' backward rules add ds + 2 y dss to g).  In
eval mode the block is plain torch ops with the running statistics.

Activations are NHWC; the matmuls see (rows, channels) views of them.
The train / eval flag is an explicit argument of `forward`.

Under a data-parallel mesh (models/train.py) `groups` are the mesh's
axes: the kernels still compute this rank's columns, and their moments
are averaged over the ranks outside them (models/norm.py
`global_moments`, a differentiable psum), so every statistic is the
global batch's, as GSPMD gives the reference's; bn2 and the
projection's norm take the same groups.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_linear import affine_relu_matmul_stats, dot_f32, matmul_stats
from .norm import batch_stats, ema_update, global_moments

MOMENTUM, EPSILON = 0.9, 1e-5


class _BNState:
    """One folded BatchNorm's parameters and running statistics, held on
    the block as `{name}_scale`, `{name}_bias` (parameters) and
    `{name}_mean`, `{name}_var` (buffers), flax's names."""

    def __init__(self, block, name, features, zero_init_scale=False):
        init = torch.zeros if zero_init_scale else torch.ones
        block.register_parameter(f"{name}_scale",
                                 nn.Parameter(init(features)))
        block.register_parameter(f"{name}_bias",
                                 nn.Parameter(torch.zeros(features)))
        block.register_buffer(f"{name}_mean", torch.zeros(features))
        block.register_buffer(f"{name}_var", torch.ones(features))
        self.block, self.name = block, name

    def _get(self, what):
        return getattr(self.block, f"{self.name}_{what}")

    def fold(self, mean, var):
        """(mean, var) -> per-channel (scale, shift) of the affine z =
        scale * y + shift equal to gamma * (y - mean) / sigma + beta."""
        scale = self._get("scale") * torch.rsqrt(var + EPSILON)
        return scale, self._get("bias") - mean * scale

    def fold_running(self):
        return self.fold(self._get("mean"), self._get("var"))

    def update(self, mean, var):
        ema_update(self._get("mean"), self._get("var"), mean, var, MOMENTUM)


class FusedBottleneckBlock(nn.Module):
    """Bottleneck block with kernel-fused 1x1 conv + BN, constructed like
    the port's BottleneckResNetBlock: `conv` and `norm` are the ResNet's
    factories (`conv(c_in, c_out, kernel, strides, name)`, `norm(features,
    name=...)`), `conv1x1` the matmul 1x1 factory or None.  The folded
    norms take the ResNet's norm settings, momentum 0.9 and epsilon
    1e-5."""

    flax_class = "FusedBottleneckBlock"

    def __init__(self, c_in, filters, conv, norm, act=torch.relu,
                 strides=(1, 1), conv1x1=None):
        super().__init__()
        c4, c_out = filters, 4 * filters
        self.filters, self.strides, self.act = filters, tuple(strides), act
        self.conv1_kernel = nn.Parameter(torch.zeros((c_in, c4)))
        self.conv3_kernel = nn.Parameter(torch.zeros((c4, c_out)))
        self.bn1 = _BNState(self, "bn1", c4)
        self.bn2 = _BNState(self, "bn2", c4)
        self.bn3 = _BNState(self, "bn3", c_out, zero_init_scale=True)
        self.conv2 = conv(c4, c4, (3, 3), strides, name="conv2")
        self.conv_proj = self.norm_proj = None
        if self.strides != (1, 1) or c_in != c_out:
            if conv1x1 is not None:
                self.conv_proj = conv1x1(c_in, c_out, strides,
                                         name="conv_proj")
            else:
                self.conv_proj = conv(c_in, c_out, (1, 1), strides,
                                      name="conv_proj")
            self.norm_proj = norm(c_out, name="norm_proj")
        self.groups = ()  # a data-parallel mesh's axes: global statistics

    def forward(self, x, train):
        c_in = x.shape[-1]
        c4, c_out = self.filters, 4 * self.filters
        dtype = x.dtype
        n, h, w, _ = x.shape
        m = n * h * w
        w1 = self.conv1_kernel.to(dtype)
        w3 = self.conv3_kernel.to(dtype)
        if not train:
            # Plain torch ops with the running statistics.
            y1 = dot_f32(x.reshape(m, c_in), w1)
            sc1, sh1 = self.bn1.fold_running()
            z1 = torch.relu(y1 * sc1 + sh1).to(dtype)
        else:
            y1, s1, ss1 = matmul_stats(x.reshape(m, c_in), w1)
            mean1, ex1 = global_moments(s1 / m, ss1 / m, self.groups)
            var1 = ex1 - mean1 * mean1
            self.bn1.update(mean1, var1)
            sc1, sh1 = self.bn1.fold(mean1, var1)
            z1 = torch.relu(y1.float() * sc1 + sh1).to(dtype)
        y2 = self.conv2(z1.reshape(n, h, w, c4))
        n2, h2, w2, _ = y2.shape
        m2 = n2 * h2 * w2
        if not train:
            sc2, sh2 = self.bn2.fold_running()
            z2 = torch.relu(y2.float() * sc2 + sh2).to(dtype)
            y3 = dot_f32(z2.reshape(m2, c4), w3).to(dtype)
            sc3, sh3 = self.bn3.fold_running()
        else:
            mean2, var2 = batch_stats(y2, self.groups)
            self.bn2.update(mean2, var2)
            sc2, sh2 = self.bn2.fold(mean2, var2)
            # z2 = relu(sc2 * y2 + sh2) is applied as the kernel reads
            # its operand: never materialized.
            y3, s3, ss3 = affine_relu_matmul_stats(
                y2.reshape(m2, c4), sc2, sh2, w3)
            mean3, ex3 = global_moments(s3 / m2, ss3 / m2, self.groups)
            var3 = ex3 - mean3 * mean3
            self.bn3.update(mean3, var3)
            sc3, sh3 = self.bn3.fold(mean3, var3)
        z3 = (y3.float() * sc3 + sh3).to(dtype).reshape(n2, h2, w2, c_out)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return self.act(residual + z3)
