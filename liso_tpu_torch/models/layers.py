"""Layers with flax semantics, shared by the port's models.

flax's `nn.Conv` pads 'SAME' the way XLA does: on a strided conv the extra
pad goes on the right (a 3x3 stride-2 conv on an even input pads (0, 1), a
7x7 stride-2 conv (2, 3)), where torch's symmetric `padding` would shift
the output. flax's `dtype=` casts inputs and kernels per op and keeps the
parameters and norm statistics in fp32; `Conv`, `GroupNorm` and
`BatchNorm` here do the same with `dtype`.

An eval `BatchNorm` + ReLU without autograd is one launch of the
`bn_relu_eval` kernel on the card; CPU tensors and every call inside
`kernels.plain_versions()` take its composition, `bn_relu_eval_plain`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from liso_tpu_torch import kernels
from liso_tpu_torch.parallel.mesh import batch_sum, batch_total


def same_pads(size: int, k: int, stride: int):
    """XLA 'SAME' (lo, hi) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _compute_dtype(dtype, x: torch.Tensor, w: torch.Tensor):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Conv(nn.Conv2d):
    """flax `nn.Conv` (NCHW): XLA 'SAME' padding, optional compute dtype.
    `cudnn=False` runs the forward through PyTorch's own CUDA convolution
    (im2col and a cuBLAS GEMM) instead of cuDNN's, for a shape where
    cuDNN's choice is pathological; the backward stays cuDNN's. An int
    `padding` pads every side by that much (flax's explicit ((p, p), (p,
    p)), torch's own convention) instead of 'SAME'."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True,
                 dtype=None, cudnn=True, padding=None, device=None):
        super().__init__(cin, cout, k, stride=stride, padding=0,
                         groups=groups, bias=bias, device=device)
        self.dtype = dtype
        self.cudnn = cudnn
        self.explicit_padding = padding

    def forward(self, x):
        if self.cudnn or not torch.backends.cudnn.enabled:
            return self._forward(x)
        torch.backends.cudnn.enabled = False
        try:
            return self._forward(x)
        finally:
            torch.backends.cudnn.enabled = True

    def _forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if self.explicit_padding is None:
            ph = same_pads(x.shape[-2], k, s)
            pw = same_pads(x.shape[-1], k, s)
        else:
            ph = pw = (self.explicit_padding, self.explicit_padding)
        dt = _compute_dtype(self.dtype, x, self.weight)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, b, s, (ph[0], pw[0]), 1, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, s, 0, 1, self.groups)


class ConvTranspose(nn.ConvTranspose2d):
    """flax `nn.ConvTranspose` with kernel == stride, 'SAME' padding, no
    bias: every input pixel maps to its own stride x stride output block.
    flax does not flip the kernel (transpose_kernel=False); the weight
    bridge flips it so that torch's conv_transpose gives the same result."""

    def __init__(self, cin, cout, stride, dtype=None, device=None):
        super().__init__(cin, cout, stride, stride=stride, bias=False,
                         device=device)
        self.dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.dtype, x, self.weight)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  stride=self.stride)


class GroupNorm(nn.GroupNorm):
    """flax `GroupNorm`: by default `group_size=1`, a per-channel instance
    norm; `num_groups` groups of channels otherwise. Scale and bias unless
    `affine=False` (flax's use_scale=use_bias=False); statistics in fp32,
    output in `dtype` (else the input's)."""

    def __init__(self, c, eps, dtype=None, num_groups=None, affine=True,
                 device=None):
        super().__init__(num_groups or c, c, eps=eps, affine=affine,
                         device=device)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(dt)


def batch_norm_eval(x, running_mean, running_var, weight, bias, eps,
                    channel_dim=1, dtype=None):
    """Eval BatchNorm over `channel_dim`: (x - running_mean) * rsqrt(
    running_var + eps) * weight + bias, each op in fp32 as written, output
    in `dtype` (else fp32)."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    v = lambda t: t.reshape(shape)
    y = (x.float() - v(running_mean)) * v(torch.rsqrt(running_var + eps))
    y = y * v(weight) + v(bias)
    return y.to(dtype) if dtype is not None else y


def bn_relu_eval_plain(x, running_mean, running_var, weight, bias, eps,
                       channel_dim=1, dtype=None):
    """relu(batch_norm_eval(...)): the plain version of `bn_relu_eval`."""
    return torch.relu(batch_norm_eval(x, running_mean, running_var, weight,
                                      bias, eps, channel_dim, dtype))


_BN_DTYPES = (torch.float32, torch.bfloat16)


def bn_relu_eval(x, running_mean, running_var, weight, bias, eps,
                 channel_dim=1, dtype=None):
    """`bn_relu_eval_plain` in one pass: on the card one launch of
    `kernels/bn_relu_eval.cu`, which reads x once and writes the result
    once, bitwise the plain version (bf16 or fp32 in and out; the norm's
    statistics and affine in fp32), in x's layout (contiguous or, for NCHW,
    channels_last). CPU tensors take the plain version, and so does every
    call inside `kernels.plain_versions()` (`kernels.use_plain`).
    No autograd: callers run it without a gradient."""
    if kernels.use_plain(x):
        return bn_relu_eval_plain(x, running_mean, running_var, weight, bias,
                                  eps, channel_dim, dtype)
    out_dtype = dtype or torch.float32
    if x.dtype not in _BN_DTYPES or out_dtype not in _BN_DTYPES:
        raise TypeError(f"bn_relu_eval takes fp32 or bf16, got {x.dtype} -> "
                        f"{out_dtype}")
    # the kernel walks x's memory, so it keeps x's layout as the composition
    # does: NCHW in channels_last memory (CenterPoint's maps, since its
    # input is a channels-last image) is channel-last there
    if not (x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last))):
        x = x.contiguous()
    cd = channel_dim % x.dim()
    c = x.shape[cd]
    inner = x.stride(cd) if c > 1 else x.numel()
    consts = [t.contiguous() for t in (running_mean,
                                       torch.rsqrt(running_var + eps),
                                       weight, bias)]
    for t in consts:
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device:
            raise ValueError(f"bn_relu_eval: a constant {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} for {c} "
                             f"channels of {x.device}")
    out = torch.empty_like(x, dtype=out_dtype)
    if out.numel():
        kernels.check(
            kernels.function("bn_relu_eval")(
                x.data_ptr(), *(t.data_ptr() for t in consts), out.data_ptr(),
                x.numel() // inner, c, inner, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), kernels.stream(x.device),
            ),
            "bn_relu_eval",
        )
        kernels.launches["bn_relu_eval"] += 1
    return out


class BatchNorm(nn.Module):
    """flax `BatchNorm(momentum=0.99, use_fast_variance=False)` over the
    last axis of a [..., C] tensor or the channel axis of NCHW
    (`channel_dim`), computed in fp32, output in `dtype` (else fp32). The
    mode follows `self.training`:
      * eval: (x - running_mean) * rsqrt(running_var + eps) * scale + bias
        (`batch_norm_eval`; `forward_relu` adds the ReLU, in one kernel
        where it can);
      * train: the same with the batch mean and the biased variance over
        every axis but the channels, and the running statistics move as
        running = 0.99 running + 0.01 batch (flax keeps the biased
        variance; torch's momentum is flax's 1 - momentum).
    With a process group in `group` (`set_batch_norm_group`) the train
    statistics are those of the global batch over the group's ranks, as
    the JAX step sharded over a mesh takes them."""

    MOMENTUM = 0.99

    def __init__(self, c, eps=1e-3, dtype=None, channel_dim=1, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.eps = eps
        self.dtype = dtype
        self.channel_dim = channel_dim
        self.group = None

    def forward(self, x):
        if not self.training:
            return batch_norm_eval(x, *self._eval_args())
        y = self._train_forward(x)
        return y.to(self.dtype) if self.dtype is not None else y

    def _eval_args(self):
        return (self.running_mean, self.running_var, self.weight, self.bias,
                self.eps, self.channel_dim, self.dtype)

    def forward_relu(self, x):
        """relu(self(x)). In eval mode, without autograd, on the card: one
        launch of the `bn_relu_eval` kernel, bitwise the same."""
        if self.training or not x.is_cuda or torch.is_grad_enabled():
            return torch.relu(self(x))
        return bn_relu_eval(x, *self._eval_args())

    def _train_forward(self, x):
        """One fused `F.batch_norm` normalises with the batch mean and the
        biased variance (Welford's update, free of the one-pass
        E[x^2] - E[x]^2 cancellation that use_fast_variance=False avoids).
        Its buffers, run at momentum 1, receive the batch mean and the
        UNBIASED variance; the biased one is that times (n - 1) / n.
        With a group: two passes over the global batch instead."""
        if self.group is not None:
            return self._train_forward_global(x)
        x = x.float().movedim(self.channel_dim, 1)
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var_unbiased, self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.eps)
        with torch.no_grad():
            var = var_unbiased * ((n - 1) / n)
            self.running_mean.mul_(self.MOMENTUM).add_(
                (1 - self.MOMENTUM) * mean)
            self.running_var.mul_(self.MOMENTUM).add_(
                (1 - self.MOMENTUM) * var)
        return y.movedim(1, self.channel_dim)

    def _train_forward_global(self, x, mask=None):
        """flax's two-pass statistics over the group's global batch (the
        local batch without a group): the mean, then the mean of squared
        deviations (biased), each a sum over the ranks that the gradient
        passes through, over the global count of rows (of rows where
        `mask` is set). Normalises with them and
        moves the running statistics; every rank gets the same ones."""
        x = x.float().movedim(self.channel_dim, -1)
        dims = tuple(range(x.dim() - 1))
        m = (torch.ones_like(x[..., :1]) if mask is None
             else mask[..., None].to(x.dtype))
        n = batch_total(m.sum(), self.group).clamp(min=1.0)
        mean = batch_sum((x * m).sum(dims), self.group) / n
        var = batch_sum(((x - mean) ** 2 * m).sum(dims), self.group) / n
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(
                (1 - self.MOMENTUM) * mean)
            self.running_var.mul_(self.MOMENTUM).add_(
                (1 - self.MOMENTUM) * var)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.movedim(-1, self.channel_dim)


def set_batch_norm_group(module: nn.Module, group) -> nn.Module:
    """Every BatchNorm (and MaskedBatchNorm) of `module` takes its train
    statistics over `group`'s global batch (None: the local batch). A group
    of one rank holds the whole batch: its norms stay local."""
    if group is not None and torch.distributed.get_world_size(group) == 1:
        group = None
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


def init_weights(module: nn.Module, seed: int, small_std=()) -> nn.Module:
    """Seeded random weights, made on the CPU from one torch.Generator so
    they do not depend on the device: kernels ~ N(0, 1/fan_in) (flax's
    lecun-normal scale), biases 0, norm scales 1 and shifts 0 (GroupNorm,
    LayerNorm, BatchNorm), BN running stats (0, 1). Modules whose name is
    in `small_std` draw N(0, 1e-2), flax's init of the flow heads."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = 1e-2 if name.split(".")[-1] in small_std else (
                    1.0 / math.sqrt(fan_in)
                )
                w.copy_(torch.randn(w.shape, generator=gen) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return module
