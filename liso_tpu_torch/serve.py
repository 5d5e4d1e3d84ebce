"""Serving entry points: the fused SLIM-flow + CenterPoint-detect forward
(port of __graft_entry__.py's `fused_forward` and bench.py's
`fused_streaming`).

`build_models` builds the two models on the card unless the caller passes
`device="cpu"`; without CUDA and without that request it raises. The
forward functions run under `torch.inference_mode()` on the models' device.
`plain=True` runs each of them inside `kernels.plain_versions()`: every
kernel's plain PyTorch version runs on the card, the eval BatchNorm + ReLU
composition (`models/layers.bn_relu_eval`) included, and the flow stage
is eager; only tests and chip_smoke.py pass it.

On the card `fused_streaming` replays its flow stage (K2, the GRU
iterations, the upsampling: about 800 launches at 6 iterations) as one
CUDA graph: a model's first call with the stage's shapes runs it eagerly
on a side stream as a warm-up, captures it and replays it; later calls
with the same shapes copy their inputs into the graph's and replay. A
graph launches the same kernels in the same order on the same values, so
its flow is bitwise the eager stage's. Every other caller of
`flow_from_features` runs the eager loop.
"""
from __future__ import annotations

import weakref

import torch

from liso_tpu_torch import kernels
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
    with kernels.plain_versions(plain):
        out_fw, _, _, _ = slim(pts0, valid0, pts1, valid1, backward=False,
                               upsample_all=False)
        boxes, _, _, _ = det(pts0, valid0)
    return out_fw[-1][..., 4:6], boxes.pos, boxes.probs


@torch.inference_mode()
def encode(slim: SlimModel, pts, valid, plain: bool = False):
    """(fmap, cnet) of one frame, the state `fused_streaming` carries."""
    with kernels.plain_versions(plain):
        fmap, cn, _ = slim.encode_frame(pts, valid)
    return fmap, cn


@torch.inference_mode()
def fused_streaming(slim: SlimModel, det: BoxLearner, fmap_prev, cn_prev,
                    pts, valid, plain: bool = False):
    """One streaming step: encode the new frame once, flow from the cached
    previous-frame features, detect on the new frame. The pillar prep is
    computed once for both networks and both networks' point features are
    scattered by ONE kernel launch. Returns (fmap, cn, flow, pos, probs).
    Its four stages are spans (`utils/trace.py`): `stream.pillars`,
    `stream.encode`, `stream.flow` and `stream.detect`. On the card the
    flow stage is a CUDA graph (the module's docstring); the flow returned
    is the caller's own tensor either way."""
    with kernels.plain_versions(plain):
        with trace.span("stream.pillars"):
            prepared = prepare_pillar_inputs(pts, valid, slim.bev)
            x_slim, _ = slim.pillar_point_feats(pts, valid, prepared=prepared)
            x_det, _ = det.point_feats(pts, valid, prepared=prepared)
            (img_s, img_d), occ = fused_scatter_images(
                [x_slim, x_det], prepared, slim.bev, dtype=slim.compute_dtype)
        with trace.span("stream.encode"):
            fmap, cn, _ = slim.encode_frame(pts, valid,
                                            pillar_image=(img_s, occ))
        with trace.span("stream.flow"):
            flow = _flow_stage(slim, fmap_prev, cn_prev, fmap)
        with trace.span("stream.detect"):
            boxes, _, _, _ = det(pts, valid, pillar_image=(img_d, occ))
    return fmap, cn, flow, boxes.pos, boxes.probs


# The captured flow stage of `fused_streaming`, per model: (its
# `flow_graph_key`, its _FlowGraph). A graph dies with its model, and two
# models never share one; a model holds one, captured again when the key
# changes.
_flow_graphs: "weakref.WeakKeyDictionary[SlimModel, tuple]" = (
    weakref.WeakKeyDictionary())


def flow_graph_key(slim: SlimModel, fmap_prev, cn_prev, fmap) -> tuple:
    """What a captured flow stage depends on: its inputs' shapes, strides
    and dtypes, the device, the iteration count and the storage of the
    model's parameters and buffers. Weights loaded in place keep the key
    (a replay reads the new values); replaced ones change it."""
    return (
        tuple((t.shape, t.stride(), t.dtype) for t in (fmap_prev, cn_prev,
                                                        fmap)),
        fmap.device, slim.raft.num_iters,
        tuple(t.data_ptr() for t in slim.parameters()),
        tuple(t.data_ptr() for t in slim.buffers()),
    )


def _eager_flow(slim: SlimModel, fmap_prev, cn_prev, fmap):
    return slim.flow_from_features(fmap_prev, cn_prev, fmap)[-1][..., 4:6]


class _FlowGraph:
    """One captured flow stage: its static inputs, the graph, its static
    flow, and the kernel launches (`kernels.launches`) of one replay.
    Before the capture the stage runs once eagerly on a side stream, which
    settles cuDNN's plans and K2's shared-memory limit."""

    def __init__(self, slim: SlimModel, fmap_prev, cn_prev, fmap):
        self.inputs = [torch.empty_like(t).copy_(t)
                       for t in (fmap_prev, cn_prev, fmap)]
        side = torch.cuda.Stream(device=fmap.device)
        side.wait_stream(torch.cuda.current_stream(fmap.device))
        with torch.cuda.stream(side):
            _eager_flow(slim, *self.inputs)
        torch.cuda.current_stream(fmap.device).wait_stream(side)
        warm = dict(kernels.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.flow = _eager_flow(slim, *self.inputs).contiguous()
        # the capture ran the wrappers but launched nothing: their counts
        # are added back on each replay instead
        self.launches = {k: n - warm[k] for k, n in kernels.launches.items()
                         if n != warm[k]}
        for k, n in self.launches.items():
            kernels.launches[k] -= n

    def replay(self, fmap_prev, cn_prev, fmap) -> torch.Tensor:
        """The flow of these inputs, in a fresh tensor (the next replay
        overwrites the static one)."""
        for static, t in zip(self.inputs, (fmap_prev, cn_prev, fmap)):
            static.copy_(t)
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.launches[k] += n
        return self.flow.clone()


def _flow_stage(slim: SlimModel, fmap_prev, cn_prev, fmap):
    """`fused_streaming`'s flow [B, H, W, 2]: eager for CPU tensors and
    inside `kernels.plain_versions()`; on the card replayed from the
    model's graph, captured first when the model has none for these
    inputs' key. Counts `stream.flow_graph.eager`, `.captures` and
    `.replays`."""
    if kernels.use_plain(fmap) or fmap.device.type != "cuda":
        trace.count("stream.flow_graph.eager")
        return _eager_flow(slim, fmap_prev, cn_prev, fmap)
    key = flow_graph_key(slim, fmap_prev, cn_prev, fmap)
    held = _flow_graphs.get(slim)
    if held is None or held[0] != key:
        _flow_graphs.pop(slim, None)  # free the old graph's pool first
        held = _flow_graphs[slim] = (
            key, _FlowGraph(slim, fmap_prev, cn_prev, fmap))
        trace.count("stream.flow_graph.captures")
    trace.count("stream.flow_graph.replays")
    return held[1].replay(fmap_prev, cn_prev, fmap)
