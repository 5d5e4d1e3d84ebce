"""RAFT-small BEV scene-flow backbone (port of liso_tpu/models/raft.py:
the joint-encoder tower and the reference's twin towers, with or without
the classification logits, inference and training).

Modules run NCHW; the public `RAFT.encode` and `RAFT.flow_from_features`
keep liso_tpu's channels-last layout at their boundary. The correlation
lookup is the fused window lookup of ops/corr_fused.py (the CUDA kernel on
the card); `build_corr_pyramid` + `lookup_corr` are the plain gather path on
a materialised volume, kept as the reference the tests hold it to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from liso_tpu_torch.models.layers import Conv, GroupNorm
from liso_tpu_torch.ops.corr_fused import (
    corr_window_features,
    level_geometry,
    pool_f1_levels,
)


def _norm(kind: str, c: int, dtype=None, device=None):
    """liso_tpu's norms (`raft_fnet_norm`): `instance_affine` (flax
    GroupNorm(group_size=1, eps=1e-3) with scale and bias), `instance`
    (eps 1e-5, no scale or bias), `group` (c // 8 groups, flax's eps 1e-6)
    and `none`."""
    kw = dict(dtype=dtype, device=device)
    if kind == "instance_affine":
        return GroupNorm(c, 1e-3, **kw)
    if kind == "instance":
        return GroupNorm(c, 1e-5, affine=False, **kw)
    if kind == "group":
        return GroupNorm(c, 1e-6, num_groups=c // 8, **kw)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip (1x1 conv + norm when the shape changes).

    `torch_compat` keeps two quirks of the reference's layout, so that its
    checkpoints load value-exact (models/torch_compat.py): symmetric
    padding on the 3x3 convs (XLA 'SAME' pads a strided conv short on the
    left, torch on the right), and with `force_down` the 1x1 `down` conv
    that the reference builds on the second block of a stage."""

    def __init__(self, cin, filters, stride=1, norm_fn="instance_affine",
                 dtype=None, torch_compat=False, force_down=False,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        pad = 1 if torch_compat else None
        self.conv1 = Conv(cin, filters, 3, stride, padding=pad, **kw)
        self.norm1 = _norm(norm_fn, filters, **kw)
        self.conv2 = Conv(filters, filters, 3, 1, padding=pad, **kw)
        self.norm2 = _norm(norm_fn, filters, **kw)
        self.down = None
        if stride != 1 or cin != filters or (force_down and torch_compat):
            self.down = Conv(cin, filters, 1, stride, **kw)
            self.norm3 = _norm(norm_fn, filters, **kw)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.down is not None:
            x = self.norm3(self.down(x))
        return torch.relu(x + y)


_STAGES = ("layer1a", "layer1b", "layer2a", "layer2b", "layer3a", "layer3b")


class SmallEncoder(nn.Module):
    """The reference's tower: a 7x7/2 stem, three residual stages (32,
    64/2, 96/2) and a 1x1 head; total stride 8. NCHW in, fp32 NCHW out.
    `torch_compat` pads the stem and the blocks symmetrically and keeps
    the second blocks' redundant `down` (ResidualBlock)."""

    def __init__(self, cin, output_dim=128, norm_fn="instance_affine",
                 dtype=None, torch_compat=False, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(cin, 32, 7, 2, padding=3 if torch_compat else None,
                          **kw)
        self.norm1 = _norm(norm_fn, 32, **kw)
        widths = (32, 32, 64, 64, 96, 96)
        prev = 32
        for name, f in zip(_STAGES, widths):
            setattr(self, name, ResidualBlock(
                prev, f, 2 if name in ("layer2a", "layer3a") else 1, norm_fn,
                torch_compat=torch_compat,
                force_down=name in ("layer2b", "layer3b"), **kw))
            prev = f
        self.conv2 = Conv(96, output_dim, 1, **kw)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        for name in _STAGES:
            x = getattr(self, name)(x)
        return self.conv2(x).float()


class JointEncoder(nn.Module):
    """fnet + cnet as ONE residual tower (48/96/144, total stride 8) with
    two 1x1 output heads. NCHW in, (fmap, ctx) NCHW fp32 out."""

    def __init__(self, cin, fmap_dim=128, ctx_dim=160,
                 norm_fn="instance_affine", dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(cin, 48, 7, 2, **kw)
        self.norm1 = _norm(norm_fn, 48, **kw)
        self.layer1a = ResidualBlock(48, 48, 1, norm_fn, **kw)
        self.layer1b = ResidualBlock(48, 48, 1, norm_fn, **kw)
        self.layer2a = ResidualBlock(48, 96, 2, norm_fn, **kw)
        self.layer2b = ResidualBlock(96, 96, 1, norm_fn, **kw)
        self.layer3a = ResidualBlock(96, 144, 2, norm_fn, **kw)
        self.layer3b = ResidualBlock(144, 144, 1, norm_fn, **kw)
        self.fmap_head = Conv(144, fmap_dim, 1, **kw)
        self.ctx_head = Conv(144, ctx_dim, 1, **kw)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        for name in _STAGES:
            x = getattr(self, name)(x)
        return self.fmap_head(x).float(), self.ctx_head(x).float()


# ---------------------------------------------------------------------------
# Plain gather lookup on a materialised volume (test reference)
# ---------------------------------------------------------------------------
def build_corr_pyramid(fmap0, fmap1, num_levels: int = 4, out_dtype=None):
    """fmap* [B, H, W, C] -> tuple of [B, H*W, Hk, Wk] volumes, each the
    correlation of f0 with the 2x2-avg-pooled fmap1 (corr is linear in
    fmap1), scaled by 1/sqrt(C)."""
    b, h, w, c = fmap0.shape
    f0 = fmap0.reshape(b, h * w, c).float()
    pyramid = []
    f1l = fmap1.float().permute(0, 3, 1, 2)
    for _ in range(num_levels):
        hk, wk = f1l.shape[-2:]
        corr = torch.matmul(f0, f1l.reshape(b, c, hk * wk)) * (1.0 / c**0.5)
        if out_dtype is not None:
            corr = corr.to(out_dtype)
        pyramid.append(corr.reshape(b, h * w, hk, wk))
        if min(hk, wk) < 4:
            break
        f1l = F.avg_pool2d(f1l, 2, 2)
    return tuple(pyramid)


def lookup_corr(pyramid, coords: torch.Tensor, radius: int = 3):
    """Bilinear (2r+1)^2 window of every level around coords [B, H, W, 2]
    (row, col); out-of-range taps read 0. Returns [B, H, W, L*(2r+1)^2]
    fp32 in the reference's tap order."""
    b, h, w, _ = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 2, device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hk, wk = corr.shape[-2:]
        centers = coords.reshape(b, h * w, 2) / (2.0**lvl)
        r0 = torch.floor(centers[..., 0])
        c0 = torch.floor(centers[..., 1])
        fr = (centers[..., 0] - r0)[..., None, None]
        fc = (centers[..., 1] - c0)[..., None, None]
        rows_u = r0.long()[..., None] + d
        cols_u = c0.long()[..., None] + d
        vr = ((rows_u >= 0) & (rows_u < hk)).float()
        vc = ((cols_u >= 0) & (cols_u < wk)).float()
        flat = (
            rows_u.clamp(0, hk - 1)[..., :, None] * wk
            + cols_u.clamp(0, wk - 1)[..., None, :]
        )
        wnd = torch.gather(
            corr.reshape(b, h * w, hk * wk).float(), 2,
            flat.reshape(b, h * w, -1),
        ).reshape(b, h * w, win + 1, win + 1)
        wnd = wnd * vr[..., :, None] * vc[..., None, :]
        s = (
            wnd[..., :win, :win] * (1 - fr) * (1 - fc)
            + wnd[..., :win, 1:] * (1 - fr) * fc
            + wnd[..., 1:, :win] * fr * (1 - fc)
            + wnd[..., 1:, 1:] * fr * fc
        )
        out.append(s.transpose(-2, -1).reshape(b, h, w, win * win))
    return torch.cat(out, dim=-1)


def make_corr_lookup(pyramid, radius: int = 3):
    """A coords -> [B, H, W, L*(2r+1)^2] lookup closure over a materialised
    pyramid (the JAX package's gather path; its TPU 'mm' path is the MXU
    form of the same values, whose counterpart on the card is K2)."""
    return lambda coords: lookup_corr(pyramid, coords, radius)


def lookup_corr_dispatch(pyramid, coords, radius: int = 3) -> torch.Tensor:
    """One-shot `make_corr_lookup(pyramid, radius)(coords)`."""
    return make_corr_lookup(pyramid, radius)(coords)


# ---------------------------------------------------------------------------
# Update block
# ---------------------------------------------------------------------------
class ConvGRU(nn.Module):
    """GRU cell with the z and r gates in ONE conv (convzr)."""

    def __init__(self, hidden_dim=96, input_dim=208, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.hidden_dim = hidden_dim
        self.convzr = Conv(hidden_dim + input_dim, 2 * hidden_dim, 3, **kw)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 3, **kw)

    def forward(self, h, x):
        zr = self.convzr(torch.cat([h, x], dim=1))
        z = torch.sigmoid(zr[:, : self.hidden_dim])
        r = torch.sigmoid(zr[:, self.hidden_dim :])
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return ((1 - z) * h + z * q).float()


class FlowClsHead(nn.Module):
    """The reference's flow (or classification) head: a 3x3 conv to
    `hidden_dim`, ReLU, a 3x3 conv to `out_dims`; fp32 out."""

    def __init__(self, cin, hidden_dim=128, out_dims=2, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(cin, hidden_dim, 3, **kw)
        self.conv2 = Conv(hidden_dim, out_dims, 3, **kw)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x))).float()


class SmallMotionEncoder(nn.Module):
    """Motion features from corr, flow and logits. With `predict_logits`
    the flow and logits branches are fused into one 7x7 + one 3x3 conv
    (liso_tpu layout; 144 channels out); without, the flow branch alone
    (`conv_flow1`, `conv_flow2`; 112 channels out). `flow_channels` is 3
    when the static-aggregation weight logit rides with the flow."""

    def __init__(self, corr_channels, flow_channels=2, predict_logits=True,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.predict_logits = predict_logits
        self.conv_stat_corr1 = Conv(corr_channels, 96, 1, **kw)
        if predict_logits:
            self.conv_flowcls1 = Conv(flow_channels + 4, 128, 7, **kw)
            self.conv_flowcls2 = Conv(128, 64, 3, **kw)
            self.conv = Conv(96 + 64, 80, 3, **kw)
        else:
            self.conv_flow1 = Conv(flow_channels, 64, 7, **kw)
            self.conv_flow2 = Conv(64, 32, 3, **kw)
            self.conv = Conv(96 + 32, 80, 3, **kw)

    @property
    def out_channels(self) -> int:
        return 80 + (64 if self.predict_logits else 32)

    def forward(self, flow, corr, logits):
        c = torch.relu(self.conv_stat_corr1(corr))
        if self.predict_logits:
            fl = torch.relu(self.conv_flowcls1(torch.cat([flow, logits], dim=1)))
            fl = torch.relu(self.conv_flowcls2(fl))
        else:
            fl = torch.relu(self.conv_flow2(torch.relu(self.conv_flow1(flow))))
        out = torch.relu(self.conv(torch.cat([c, fl], dim=1)))
        return torch.cat([out, fl], dim=1)


class SmallUpdateBlock(nn.Module):
    """Motion encoder + GRU + heads. With `predict_logits`: the fused
    flow/classification heads, one 3x3 hidden conv for both and one
    grouped (groups=2) output conv, each group reading only its own head's
    hidden half; without: the flow head alone (`static_flow_head`) and no
    logits. With `predict_weight_for_static_aggregation` the weight logit
    `wlog` joins the flow at the motion encoder's input and its delta is
    the flow head's channel 2."""

    def __init__(self, corr_channels, hidden_dim=96, context_dim=64,
                 predict_weight_for_static_aggregation=False,
                 predict_logits=True, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.predict_weight = predict_weight_for_static_aggregation
        self.predict_logits = predict_logits
        self.motion_encoder = SmallMotionEncoder(
            corr_channels, 3 if self.predict_weight else 2, predict_logits,
            **kw
        )
        self.gru = ConvGRU(hidden_dim,
                           context_dim + self.motion_encoder.out_channels, **kw)
        if predict_logits:
            self.heads_conv1 = Conv(hidden_dim, 256, 3, **kw)
            self.heads_conv2 = Conv(256, 8, 3, groups=2, **kw)
        else:
            self.static_flow_head = FlowClsHead(
                hidden_dim, 128, 3 if self.predict_weight else 2, **kw)

    def forward(self, net, inp, corr, flow, logits, wlog=None):
        """NCHW -> (net, delta_flow [B, 2, h, w], delta_logits [B, 4, h, w]
        or None, delta_wlog [B, 1, h, w] or None)."""
        flow_in = torch.cat([flow, wlog], dim=1) if self.predict_weight else flow
        motion = self.motion_encoder(flow_in, corr, logits)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        if not self.predict_logits:
            delta = self.static_flow_head(net)
            dw = delta[:, -1:] if self.predict_weight else None
            return net, delta[:, :2], None, dw
        h = torch.relu(self.heads_conv1(net))
        delta = self.heads_conv2(h).float()
        dw = delta[:, 2:3] if self.predict_weight else None
        return net, delta[:, :2], delta[:, 4:8], dw


# ---------------------------------------------------------------------------
def _upsample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] align-corners linear-interpolation weights."""
    pos = torch.linspace(0.0, n_in - 1.0, n_out, device=device)
    i0 = torch.floor(pos).long()
    i1 = (i0 + 1).clamp(max=n_in - 1)
    f = pos - i0
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, device=device)
    m.index_put_((rows, i0), 1.0 - f, accumulate=True)
    m.index_put_((rows, i1), f, accumulate=True)
    return m


def upsample_bilinear(x: torch.Tensor, n: int) -> torch.Tensor:
    """xN bilinear upsample of NCHW x with align_corners=True, as two dense
    interpolation matmuls per axis in fp32 (as liso_tpu computes it)."""
    b, c, h, w = x.shape
    r = _upsample_matrix(h, h * n, x.device)
    cm = _upsample_matrix(w, w * n, x.device)
    y = torch.einsum("ph,bchw->bcpw", r, x.float())
    return torch.einsum("qw,bcpw->bcpq", cm, y)


def coarse_size(n: int, downsample: int = 8) -> int:
    """Size of the encoder's output dim for an input dim of n: each of the
    three stride-2 'SAME' convs rounds up."""
    while downsample > 1:
        n = -(-n // 2)
        downsample //= 2
    return n


def corr_channels(grid_size, downsample: int = 8, corr_levels: int = 4,
                  corr_radius: int = 3) -> int:
    """The motion encoder's corr input width at a BEV grid of `grid_size`:
    the pyramid's levels (fewer on a tiny coarse grid) x (2r+1)^2."""
    hc = coarse_size(grid_size[0], downsample)
    wc = coarse_size(grid_size[1], downsample)
    n_levels = len(level_geometry(hc, wc, corr_levels).shapes)
    return n_levels * (2 * corr_radius + 1) ** 2


class RAFT(nn.Module):
    """One direction's iterative flow predictor. `flow_from_features`
    returns stacked per-iteration outputs [iters, B, H, W, 8(+1)]: 4
    logits ++ 2 static flow ++ 2 dynamic flow (++ 1 static-aggregation
    weight logit with `predict_weight_for_static_aggregation`), flows in
    meters, full BEV resolution; the logits stay 0 without
    `predict_logits`. Flow, logits and the weight logit are detached at the
    top of every iteration (`liso_tpu/models/raft.py:627-629`).

    `joint_encoders` (the default) runs one shared tower (`joint`);
    `joint_encoders=False` the reference's twin towers `fnet` (norm
    `fnet_norm`) and `cnet` (no norm). `torch_compat` needs the twin
    towers: it keeps the reference's padding and redundant downsample
    convs, so that a converted reference checkpoint
    (models/torch_compat.load_reference_raft) gives its values."""

    def __init__(self, grid_size, in_channels=64, num_iters=6, corr_levels=4,
                 corr_radius=3, hidden_dim=96, context_dim=64,
                 corr_feature_dim=128, downsample=8, resolution_m=0.2,
                 fnet_norm="instance_affine", predict_logits=True,
                 predict_weight_for_static_aggregation=False,
                 joint_encoders=True, torch_compat=False, dtype=None,
                 device=None):
        super().__init__()
        if joint_encoders and torch_compat:
            raise ValueError("torch_compat requires the reference twin-tower "
                             "layout (joint_encoders=False)")
        self.num_iters = num_iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.downsample = downsample
        self.resolution_m = resolution_m
        self.joint_encoders = joint_encoders
        self.predict_logits = predict_logits
        kw = dict(dtype=dtype, device=device)
        if joint_encoders:
            self.joint = JointEncoder(
                in_channels, corr_feature_dim, hidden_dim + context_dim,
                fnet_norm, **kw,
            )
        else:
            self.fnet = SmallEncoder(in_channels, corr_feature_dim, fnet_norm,
                                     torch_compat=torch_compat, **kw)
            self.cnet = SmallEncoder(in_channels, hidden_dim + context_dim,
                                     "none", torch_compat=torch_compat, **kw)
        self.predict_weight = predict_weight_for_static_aggregation
        self.update_block = SmallUpdateBlock(
            corr_channels(grid_size, downsample, corr_levels, corr_radius),
            hidden_dim, context_dim,
            predict_weight_for_static_aggregation, predict_logits, **kw
        )

    def encode(self, img: torch.Tensor):
        """img [B, H, W, C] -> (fmap [B, h, w, 128], cn [B, h, w, 160]),
        fp32, channels-last."""
        x = img.permute(0, 3, 1, 2)
        if self.joint_encoders:
            fmap, ctx = self.joint(x)
        else:
            fmap, ctx = self.fnet(x), self.cnet(x)
        return fmap.permute(0, 2, 3, 1), ctx.permute(0, 2, 3, 1)

    def forward(self, img0, img1, upsample_all: bool = True):
        fmap0, cn0 = self.encode(img0)
        fmap1 = self.encode(img1)[0]
        return self.flow_from_features(fmap0, cn0, fmap1, upsample_all)

    def flow_from_features(self, fmap0, cn, fmap1, upsample_all: bool = True):
        b, h, w, c = fmap0.shape
        f1cat, lvls = pool_f1_levels(fmap1, self.corr_levels)
        f0_flat = fmap0.reshape(b, h * w, c)
        cn = cn.permute(0, 3, 1, 2)
        net = torch.tanh(cn[:, : self.hidden_dim])
        inp = torch.relu(cn[:, self.hidden_dim :])
        dev = fmap0.device
        coords0 = torch.stack(
            torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij",
            ),
            dim=0,
        )[None].expand(b, 2, h, w)
        flow = torch.zeros(b, 2, h, w, device=dev)
        logits = torch.zeros(b, 4, h, w, device=dev)
        wlog = torch.zeros(b, 1, h, w, device=dev) if self.predict_weight else None
        m_per_px = self.resolution_m * self.downsample
        outputs = []
        for it in range(self.num_iters):
            flow = flow.detach()
            logits = logits.detach()
            if wlog is not None:
                wlog = wlog.detach()
            corr = corr_window_features(
                f0_flat, f1cat, coords0 + flow, lvls, self.corr_radius
            )
            net, dflow, dlogits, dw = self.update_block(
                net, inp, corr, flow, logits, wlog
            )
            flow = flow + dflow
            if self.predict_logits:
                logits = logits + dlogits
            if wlog is not None:
                wlog = wlog + dw
            if not upsample_all and it < self.num_iters - 1:
                continue  # inference: only the final iteration is consumed
            up_flow = upsample_bilinear(flow, self.downsample) * m_per_px
            outs = [upsample_bilinear(logits, self.downsample), up_flow, up_flow]
            if wlog is not None:
                outs.append(upsample_bilinear(wlog, self.downsample))
            outputs.append(torch.cat(outs, dim=1).permute(0, 2, 3, 1))
        return torch.stack(outputs, dim=0)
