"""Serving entry points: the fused SLIM-flow + CenterPoint-detect forward
(port of __graft_entry__.py's `fused_forward` and bench.py's
`fused_streaming`).

`build_models` builds the two models on the card unless the caller passes
`device="cpu"`; without CUDA and without that request it raises. The
forward functions run under `torch.inference_mode()` on the models' device.
`plain=True` runs the plain PyTorch versions of the kernels on the card;
only tests and chip_smoke.py pass it.
"""
from __future__ import annotations

import torch

from liso_tpu_torch.models.box_learner import BoxLearner
from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.models.pillar_encoder import (
    fused_scatter_images,
    prepare_pillar_inputs,
)
from liso_tpu_torch.models.slim import SlimModel
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.utils import trace


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when none is given. Raises when the card is
    asked for (explicitly or by default) and CUDA is not available."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card unless the "
            "caller passes device='cpu'"
        )
    return dev


def build_models(grid: int = 256, num_iters: int = 6, compute_dtype=None,
                 seed: int = 0, device=None):
    """(bev, slim, det) as __graft_entry__._models builds them: 100 m x
    100 m BEV at grid x grid, SLIM with `num_iters` GRU iterations,
    CenterPoint with the baseline parameters; seeded random weights, eval
    mode."""
    dev = resolve_device(device)
    bev = BevSetup(bev_range_m=(100.0, 100.0), grid_size=(grid, grid))
    slim = SlimModel(bev, num_iters=num_iters, compute_dtype=compute_dtype,
                     device=dev)
    det = BoxLearner(bev, network="centerpoint", use_baseline_parameters=True,
                     compute_dtype=compute_dtype, device=dev)
    init_weights(slim, seed, small_std=("heads_conv2",))
    init_weights(det, seed + 1)
    return bev, slim.eval(), det.eval()


@torch.inference_mode()
def fused_forward(slim: SlimModel, det: BoxLearner, pts0, valid0, pts1,
                  valid1, plain: bool = False):
    """Flow frame0 -> frame1 (SLIM forward only, final iteration) and
    CenterPoint boxes on frame 0: (flow [B, H, W, 2] meters, boxes.pos
    [B, K, 3], boxes.probs [B, K, 1])."""
    out_fw, _, _, _ = slim(pts0, valid0, pts1, valid1, backward=False,
                           upsample_all=False, plain=plain)
    boxes, _, _, _ = det(pts0, valid0, plain=plain)
    return out_fw[-1][..., 4:6], boxes.pos, boxes.probs


@torch.inference_mode()
def encode(slim: SlimModel, pts, valid, plain: bool = False):
    """(fmap, cnet) of one frame, the state `fused_streaming` carries."""
    fmap, cn, _ = slim.encode_frame(pts, valid, plain=plain)
    return fmap, cn


@torch.inference_mode()
def fused_streaming(slim: SlimModel, det: BoxLearner, fmap_prev, cn_prev,
                    pts, valid, plain: bool = False):
    """One streaming step: encode the new frame once, flow from the cached
    previous-frame features, detect on the new frame. The pillar prep is
    computed once for both networks and both networks' point features are
    scattered by ONE kernel launch. Returns (fmap, cn, flow, pos, probs).
    Its four stages are spans (`utils/trace.py`): `stream.pillars`,
    `stream.encode`, `stream.flow` and `stream.detect`."""
    with trace.span("stream.pillars"):
        prepared = prepare_pillar_inputs(pts, valid, slim.bev)
        x_slim, _ = slim.pillar_point_feats(pts, valid, prepared=prepared)
        x_det, _ = det.point_feats(pts, valid, prepared=prepared)
        (img_s, img_d), occ = fused_scatter_images(
            [x_slim, x_det], prepared, slim.bev, dtype=slim.compute_dtype,
            plain=plain,
        )
    with trace.span("stream.encode"):
        fmap, cn, _ = slim.encode_frame(pts, valid, pillar_image=(img_s, occ))
    with trace.span("stream.flow"):
        out = slim.flow_from_features(fmap_prev, cn_prev, fmap, plain=plain)
    with trace.span("stream.detect"):
        boxes, _, _, _ = det(pts, valid, pillar_image=(img_d, occ),
                             plain=plain)
    return fmap, cn, out[-1][..., 4:6], boxes.pos, boxes.probs
