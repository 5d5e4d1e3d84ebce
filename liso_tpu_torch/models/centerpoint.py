"""CenterPoint-style single-stage BEV detector (port of
liso_tpu/models/centerpoint.py). The baseline configuration
(use_baseline_parameters=True) predicts at /4 of the BEV grid; the other
runs a two-stage RPN and a stride-2 shared conv and predicts at /8. Modules
run NCHW; CenterPointNet takes and returns channels-last maps.

The mode follows `nn.Module.training`, as flax's `train` argument does: in
train mode every BatchNorm (eps 1e-3, flax momentum 0.99) normalises with
the batch statistics over (B, H, W) and moves its running statistics, and
the pillar encoder's masked BatchNorm does the same over the in-pillar
points; in eval mode the running statistics normalise."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from liso_tpu_torch.models.layers import BatchNorm, Conv, ConvTranspose
from liso_tpu_torch.models.pillar_encoder import PillarEncoder
from liso_tpu_torch.ops.bev import BevSetup


class ConvBNRelu(nn.Module):
    def __init__(self, cin, filters, stride=1, kernel=3, transpose=False,
                 dtype=None, cudnn=True, device=None):
        super().__init__()
        if transpose:
            self.conv = ConvTranspose(cin, filters, stride, dtype=dtype,
                                      device=device)
        else:
            self.conv = Conv(cin, filters, kernel, stride, bias=False,
                             dtype=dtype, cudnn=cudnn, device=device)
        self.bn = BatchNorm(filters, 1e-3, dtype=dtype, device=device)

    def forward(self, x):
        return self.bn.forward_relu(self.conv(x))


class RPNStage(nn.Module):
    def __init__(self, cin, filters, num_blocks, stride, dtype=None,
                 device=None):
        super().__init__()
        self.num_blocks = num_blocks
        self.down = ConvBNRelu(cin, filters, stride, dtype=dtype, device=device)
        for i in range(num_blocks):
            setattr(self, f"block{i}",
                    ConvBNRelu(filters, filters, 1, dtype=dtype, device=device))

    def forward(self, x):
        x = self.down(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class RPN(nn.Module):
    """Multi-scale conv/deconv backbone: three downsampling stages, each
    brought to the first stage's resolution and concatenated."""

    def __init__(self, cin, layer_nums: Sequence[int] = (3, 5, 5),
                 ds_strides: Sequence[int] = (2, 2, 2),
                 ds_filters: Sequence[int] = (64, 128, 256),
                 us_strides: Sequence[float] = (0.5, 1, 2),
                 us_filters: Sequence[int] = (128, 128, 128),
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_stages = len(layer_nums)
        self.up_start = len(layer_nums) - len(us_strides)
        for i, (n, s, f) in enumerate(zip(layer_nums, ds_strides, ds_filters)):
            setattr(self, f"stage{i}", RPNStage(cin, f, n, s, **kw))
            j = i - self.up_start
            if j >= 0:
                us, uf = us_strides[j], us_filters[j]
                if us > 1:
                    up = ConvBNRelu(f, uf, int(us), transpose=True, **kw)
                else:
                    inv = int(round(1 / us))
                    up = ConvBNRelu(f, uf, inv, kernel=inv, **kw)
                setattr(self, f"up{j}", up)
            cin = f
        self.out_channels = sum(us_filters)

    def forward(self, x):
        ups = []
        for i in range(self.n_stages):
            x = getattr(self, f"stage{i}")(x)
            j = i - self.up_start
            if j >= 0:
                ups.append(getattr(self, f"up{j}")(x))
        return torch.cat(ups, dim=1)


def two_stage_rpn_kwargs(hid_dim: int) -> dict:
    """The two-stage RPN of the non-baseline CenterPoint, TransFusion's
    backbone too: [3, 5] convs at strides [2, 2] with filters [hid, 128],
    both stages brought to /4 with 128 channels each."""
    return dict(layer_nums=(3, 5), ds_strides=(2, 2), ds_filters=(hid_dim, 128),
                us_strides=(0.5, 1), us_filters=(128, 128))


class SepHead(nn.Module):
    """Per-attribute heads with the hidden convs fused across heads into
    one conv + BN (exact: BN is per channel), then one 3x3 output conv per
    head on its own channel slice."""

    def __init__(self, cin, heads: Tuple[Tuple[str, int], ...],
                 head_conv: int = 64, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = tuple(heads)
        self.head_conv = head_conv
        self.fused_conv0 = Conv(cin, len(heads) * head_conv, 3, **kw)
        self.fused_bn0 = BatchNorm(len(heads) * head_conv, 1e-3, **kw)
        for name, channels in heads:
            setattr(self, f"{name}_final", Conv(head_conv, channels, 3, **kw))

    def forward(self, x):
        y = self.fused_bn0.forward_relu(self.fused_conv0(x))
        out = {}
        for j, (name, _) in enumerate(self.heads):
            sl = y[:, j * self.head_conv : (j + 1) * self.head_conv]
            out[name] = getattr(self, f"{name}_final")(sl).float()
        return out


class CenterPointNet(nn.Module):
    """Pillar encoder -> RPN -> shared conv -> SepHead. Returns (dict of
    channels-last [B, h, w, C] raw attribute maps, occupancy). The point
    features are scattered in `dtype` (fp32 when None, as the JAX package's
    CPU path scatters; its TPU path casts them to bf16 first)."""

    def __init__(self, bev: BevSetup,
                 head_channels=(("pos", 3), ("dims", 3), ("rot", 2),
                                ("probs", 1)),
                 hid_dim: int = 64, use_baseline_parameters: bool = True,
                 share_conv_channel: int = 64, point_features: int = 4,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.use_baseline_parameters = use_baseline_parameters
        self.pfn = PillarEncoder(bev, num_channels=hid_dim,
                                 point_features=point_features,
                                 scatter_dtype=dtype, device=device)
        if use_baseline_parameters:
            self.rpn = RPN(hid_dim, **kw)
        else:
            self.rpn = RPN(hid_dim, **two_stage_rpn_kwargs(hid_dim), **kw)
        # the non-baseline shared conv is a 3x3 at stride 2: XLA's SAME
        # pads it (0, 1) on an even map (layers.same_pads)
        self.shared_conv = ConvBNRelu(self.rpn.out_channels,
                                      share_conv_channel,
                                      1 if use_baseline_parameters else 2,
                                      **kw)
        self.sep_head = SepHead(share_conv_channel, head_channels, **kw)

    @property
    def out_downsample_factor(self) -> int:
        """BEV grid -> prediction grid factor."""
        return 4 if self.use_baseline_parameters else 8

    def forward(self, points, valid, prepared=None, pillar_image=None):
        if pillar_image is not None:
            img, occ = pillar_image
        else:
            img, occ = self.pfn(points, valid, prepared)
        x = self.rpn(img.permute(0, 3, 1, 2))
        maps = self.sep_head(self.shared_conv(x))
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}, occ
