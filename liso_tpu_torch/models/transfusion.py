"""TransFusion-style query detector (port of liso_tpu/models/transfusion.py).

pillar BEV features -> the two-stage RPN -> a 3x3 `reduce` ConvBNRelu ->
a dense per-class heatmap (3x3 conv) -> sigmoid and local-max suppression
-> the top `num_proposals` peaks over classes x cells -> query features
gathered at the peaks plus a class embedding -> decoder layers
(self-attention over the queries, cross-attention to the BEV tokens, an
FFN; each followed by a LayerNorm), each layer with its own prediction
head; the next layer's query positions come from this layer's centers.

Parity with the flax module:
  * the top-k is a stable descending sort: most of the peaks are tied
    zeros after suppression, and `jax.lax.top_k` takes ties in index order;
  * the attention is flax's MultiHeadDotProductAttention written out: the
    query, key and value projections (DenseGeneral kernels [d, heads,
    head_dim], kept here as Linear weights with the heads flattened
    head-major), the query scaled by 1/sqrt(head_dim), a softmax in fp32,
    the output projection;
  * LayerNorm's epsilon is flax's 1e-6;
  * the heatmap that picks the queries and the centers that move the next
    layer's queries carry no gradient, as in JAX (stop_gradient).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from liso_tpu_torch.models.centerpoint import (
    RPN,
    ConvBNRelu,
    two_stage_rpn_kwargs,
)
from liso_tpu_torch.models.layers import Conv
from liso_tpu_torch.models.pillar_encoder import PillarEncoder
from liso_tpu_torch.ops.bev import BevSetup

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def sine_embed(xy: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., 2] normalized positions -> [..., dim] sinusoidal embedding."""
    half = dim // 4
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=xy.device)
        * (-math.log(10000.0) / max(half - 1, 1))
    )
    out = []
    for i in range(2):
        ang = xy[..., i : i + 1] * 64.0 * freqs
        out += [torch.sin(ang), torch.cos(ang)]
    return torch.cat(out, dim=-1)


def local_max_suppress(heat: torch.Tensor, kernel: int) -> torch.Tensor:
    """heatmap [B, H, W, C] (post-sigmoid) -> peaks-only map: the interior
    max-pooled over kernel x kernel, the border's pool 0, and cells equal
    to their neighbourhood max kept."""
    if kernel <= 1:
        return heat
    pad = kernel // 2
    inner = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1)
    local_max = F.pad(inner, (pad, pad, pad, pad)).permute(0, 2, 3, 1)
    return heat * (heat == local_max)


class MultiHeadAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention(num_heads) at qkv_features =
    out_features = d, no mask, no dropout."""

    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(d, d, device=device))

    def forward(self, inputs_q, inputs_k, inputs_v):
        b, lq, d = inputs_q.shape
        hd = d // self.heads
        split = lambda x: x.reshape(b, x.shape[1], self.heads, hd)
        q = split(self.query(inputs_q))
        k = split(self.key(inputs_k))
        v = split(self.value(inputs_v))
        q = q / math.sqrt(hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(b, lq, d))


class DecoderLayer(nn.Module):
    """Self-attention + cross-attention + FFN, positional embeddings added
    to the queries and keys."""

    def __init__(self, d_model=128, nhead=8, ffn=256, device=None):
        super().__init__()
        kw = dict(device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, **kw)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}",
                    nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, **kw))
        self.ffn1 = nn.Linear(d_model, ffn, **kw)
        self.ffn2 = nn.Linear(ffn, d_model, **kw)

    def forward(self, query, query_pos_embed, key, key_pos_embed):
        q = query + query_pos_embed
        query = self.norm1(query + self.self_attn(q, q, query))
        ca = self.cross_attn(query + query_pos_embed, key + key_pos_embed, key)
        query = self.norm2(query + ca)
        h = self.ffn2(torch.relu(self.ffn1(query)))
        return self.norm3(query + h)


class PredictionHead(nn.Module):
    """One decoder layer's per-attribute FFN heads."""

    def __init__(self, d_model, head_channels, device=None):
        super().__init__()
        self.names = [name for name, _ in head_channels]
        for name, channels in head_channels:
            setattr(self, f"{name}_fc1", nn.Linear(d_model, 64, device=device))
            setattr(self, f"{name}_fc2", nn.Linear(64, channels, device=device))

    def forward(self, query):
        return {
            n: getattr(self, f"{n}_fc2")(torch.relu(getattr(self, f"{n}_fc1")(query)))
            for n in self.names
        }


class TransFusionNet(nn.Module):
    """Returns (the last layer's raw maps {attr: [B, 1, K, C]}, occupancy,
    aux with dense_heatmap [B, hh, ww, NC] logits, layer_maps (every
    layer's maps), query_heatmap_score [B, K] and query_cls [B, K])."""

    def __init__(self, bev: BevSetup,
                 head_channels=(("pos", 3), ("dims", 3), ("rot", 2),
                                ("probs", 1)),
                 hid_dim: int = 64, d_model: int = 128,
                 num_proposals: int = 200, num_decoder_layers: int = 1,
                 num_classes: int = 1, nms_kernel_size: int = 3,
                 point_features: int = 4, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.bev = bev
        self.d_model = d_model
        self.num_proposals = num_proposals
        self.num_decoder_layers = num_decoder_layers
        self.num_classes = num_classes
        self.nms_kernel_size = nms_kernel_size
        self.pfn = PillarEncoder(bev, num_channels=hid_dim,
                                 point_features=point_features,
                                 scatter_dtype=dtype, device=device)
        self.backbone = RPN(hid_dim, **two_stage_rpn_kwargs(hid_dim), **kw)
        # ConvBNRelu's kernel defaults to 3: `reduce` is a 3x3 conv. At its
        # shape (256 -> 128 channels over 128^2 cells at grid 512) cuDNN's
        # fp32 forward picks an FFT algorithm of some 33000 small complex
        # GEMMs, hundreds of times slower than PyTorch's own convolution at
        # batch 2 on an H100 (models/time_reduce_conv.py; PERF.md): the
        # forward runs through the latter
        self.reduce = ConvBNRelu(self.backbone.out_channels, d_model, 1,
                                 cudnn=False, **kw)
        self.heatmap_head = Conv(d_model, num_classes, 3, device=device)
        self.class_encoding = nn.Linear(num_classes, d_model, device=device)
        self.key_pos_mlp = nn.Linear(d_model, d_model, device=device)
        # one query position MLP, shared by every decoder layer
        self.query_pos_mlp = nn.Linear(d_model, d_model, device=device)
        for i in range(num_decoder_layers):
            setattr(self, f"decoder{i}", DecoderLayer(d_model, device=device))
            setattr(self, f"pred_head{i}",
                    PredictionHead(d_model, head_channels, device=device))

    def forward(self, points, valid):
        img, occ = self.pfn(points, valid)
        feat = self.reduce(self.backbone(img.permute(0, 3, 1, 2))).float()
        b, _, hh, ww = feat.shape
        dense_heatmap = self.heatmap_head(feat).permute(0, 2, 3, 1)
        feat = feat.permute(0, 2, 3, 1)  # [B, hh, ww, d]

        # the queries: sigmoid, local-max suppression, the top-K peaks over
        # classes x cells (class-major), ties in index order
        heat = local_max_suppress(torch.sigmoid(dense_heatmap.detach()),
                                  self.nms_kernel_size)
        flat_all = heat.permute(0, 3, 1, 2).reshape(b, -1)
        order = torch.sort(flat_all, dim=-1, descending=True, stable=True)
        peak_score = order.values[:, : self.num_proposals]
        top_all = order.indices[:, : self.num_proposals]
        top_cls = top_all // (hh * ww)
        top_idx = top_all % (hh * ww)
        qr = (top_idx // ww).float()
        qc = (top_idx % ww).float()
        tokens = feat.reshape(b, hh * ww, self.d_model)
        query = torch.gather(
            tokens, 1, top_idx[..., None].expand(-1, -1, self.d_model))
        one_hot = F.one_hot(top_cls, self.num_classes).float()
        query = query + self.class_encoding(one_hot)

        dev = feat.device
        rr, cc = torch.meshgrid(
            torch.arange(hh, dtype=torch.float32, device=dev) / hh,
            torch.arange(ww, dtype=torch.float32, device=dev) / ww,
            indexing="ij",
        )
        norm_k = torch.stack([rr, cc], -1).reshape(1, hh * ww, 2)
        k_embed = self.key_pos_mlp(
            sine_embed(norm_k.expand(b, -1, -1), self.d_model))

        # query metric positions (bev row <-> x, col <-> y)
        res_x = self.bev.bev_range_m[0] / hh
        res_y = self.bev.bev_range_m[1] / ww
        emin = self.bev.extent_min
        qx = (qr + 0.5) * res_x + emin[0]
        qy = (qc + 0.5) * res_y + emin[1]
        q_pos_norm = torch.stack([qr / hh, qc / ww], -1)
        q_pos_metric = torch.stack([qx, qy], -1)

        ps = peak_score.clamp(1e-6, 1.0 - 1e-6)
        peak_logit = torch.log(ps) - torch.log1p(-ps)

        layer_maps = []
        for i in range(self.num_decoder_layers):
            q_embed = self.query_pos_mlp(sine_embed(q_pos_norm, self.d_model))
            query = getattr(self, f"decoder{i}")(query, q_embed, tokens, k_embed)
            out = getattr(self, f"pred_head{i}")(query)
            # centers relative to the current query positions; confidence
            # fused with the suppressed heatmap peak in logit space
            pos = out["pos"]
            out["pos"] = torch.cat(
                [pos[..., :2] + q_pos_metric[..., :2], pos[..., 2:]], -1)
            out["probs"] = out["probs"] + peak_logit[..., None]
            layer_maps.append({k: v[:, None] for k, v in out.items()})
            # the next layer's positional embedding from the predicted
            # centers, normalized back to the heatmap grid
            center = out["pos"].detach()
            nr = (center[..., 0] - emin[0]) / (res_x * hh)
            nc = (center[..., 1] - emin[1]) / (res_y * ww)
            q_pos_norm = torch.stack([nr, nc], -1)
            q_pos_metric = center[..., :2]

        aux = {
            "dense_heatmap": dense_heatmap,
            "layer_maps": tuple(layer_maps),
            "query_heatmap_score": peak_score,
            "query_cls": top_cls,
        }
        return layer_maps[-1], occ, aux
