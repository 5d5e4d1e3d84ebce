"""The plain reference's two networks, with the program's parameter names
(so that one state_dict made by the benchmark loads into both), and the
reference's streaming step and detector loss.

Everything runs in fp32 with TF32 off unless `precision` names the
control's lower precision.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn

from portbench.reference.bev import BevSetup
from portbench.reference.box_decode import (
    BoxPredictionCfg,
    apply_activations,
    decode_box_maps,
    flatten_to_boxes,
)
from portbench.reference.centerpoint import CenterPointNet
from portbench.reference.pillar_encoder import PillarEncoder
from portbench.reference.raft import RAFT


class RefSlim(nn.Module):
    """SLIM's pillar encoder and RAFT (slim.SlimModel's layout)."""

    def __init__(self, bev: BevSetup, num_iters: int = 6,
                 pillar_channels: int = 64, device=None):
        super().__init__()
        self.bev = bev
        self.pillar_encoder = PillarEncoder(bev, num_channels=pillar_channels,
                                            device=device)
        self.raft = RAFT(bev.grid_size, in_channels=pillar_channels,
                         num_iters=num_iters, resolution_m=bev.res_m[0],
                         device=device)

    def encode(self, pts, valid):
        img, _ = self.pillar_encoder(pts, valid)
        return self.raft.encode(img)

    def flow(self, pts0, valid0, pts1, valid1):
        """The last iteration's flow frame0 -> frame1 [B, H, W, 2], m."""
        fmap0, cn0 = self.encode(pts0, valid0)
        fmap1, _ = self.encode(pts1, valid1)
        out = self.raft.flow_from_features(fmap0, cn0, fmap1,
                                           upsample_all=False)
        return out[-1][..., 4:6]


class RefBoxLearner(nn.Module):
    """CenterPoint with the baseline parameters (box_learner.BoxLearner's
    layout: the network under `model`)."""

    def __init__(self, bev: BevSetup, box_cfg: BoxPredictionCfg = None,
                 device=None):
        super().__init__()
        self.bev = bev
        self.box_cfg = box_cfg or BoxPredictionCfg()
        self.model = CenterPointNet(bev, head_channels=self.box_cfg.head_channels(),
                                    device=device)

    def forward(self, pts, valid):
        """-> (flat boxes {attr: [B, K, C]}, decoded maps, activated maps)."""
        raw, _ = self.model(pts, valid)
        activated = apply_activations(raw, self.box_cfg)
        decoded = decode_box_maps(activated, self.box_cfg, self.bev)
        return flatten_to_boxes(decoded), decoded, activated


def bev_of(config: dict) -> BevSetup:
    r, g = float(config["bev_range_m"]), int(config["grid_size"])
    return BevSetup((r, r), (g, g))


@contextmanager
def precision(kind: str):
    """fp32 with TF32 off ("fp32"), TF32 on for cuDNN and cuBLAS ("tf32",
    the control of an fp32 configuration), or fp32 with cuDNN's algorithms
    chosen by timing them ("fp32_autotune": other fp32 algorithms, which
    show how far fp32 rounding alone moves a number)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    on = kind == "tf32"
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.benchmark = kind == "fp32_autotune"
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one per-tensor scale (amax to 448) and
    back to fp32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def to_fp8(module: nn.Module) -> nn.Module:
    """The control of a bf16 configuration: every convolution's and linear
    layer's weights and inputs rounded to float8 e4m3 (per-tensor scale),
    products summed in fp32."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.copy_(_round_fp8(m.weight))
                m.register_forward_pre_hook(
                    lambda mod, args: (_round_fp8(args[0]),) + args[1:])
    return module
