"""The readers that find kernels by name under a program span
(`portbench/kernel_names.py`): they read kernels that a CUDA graph's replay
launched, with no operator or benchmark range open, and K2's cost taken
from the cell's shapes is the cost counted from the program's own
tensors."""
import importlib.util

import pytest
import torch

from portbench import harness, trace, yardstick
from portbench.tests.small import BENCH

K2 = "corr_window_fwd_kernel(__nv_bfloat16 const*, float*, int)"
CONV = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
        "_cudnn")
LAYOUT = ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>"
          "(float const*)")
ADD = "void at::native::elementwise_kernel<CUDAFunctor_add<float>>(int)"


def _module(metric):
    path = harness.PB / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace():
    """Two steps: each replays the flow stage as one graph launch under
    `stream.flow` (K2 twice, a convolution, its layout transform and a bias
    add), then launches a convolution under `stream.detect` through
    `aten::convolution`."""
    ev = []
    host = lambda name, ts, dur, cat="user_annotation": ev.append(  # noqa
        {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1})

    def launch(ts, corr, kernels, name="cudaGraphLaunch"):
        ev.append({"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
                   "tid": 1, "args": {"correlation": corr}})
        for kname, kts, kdur in kernels:
            ev.append({"cat": "kernel", "name": kname, "ts": kts, "dur": kdur,
                       "tid": 7, "args": {"correlation": corr}})

    host("pb.window", 0, 1000)
    for step, t0 in enumerate((0, 500)):
        host("stream.flow", t0 + 10, 20)
        launch(t0 + 15, 10 * step + 1,
               [(K2, t0 + 20, 30), (LAYOUT, t0 + 50, 5), (CONV, t0 + 55, 40),
                (ADD, t0 + 95, 3), (K2, t0 + 98, 30)])
        host("stream.detect", t0 + 200, 50)
        host("aten::convolution", t0 + 210, 10, cat="cpu_op")
        launch(t0 + 215, 10 * step + 2, [(CONV, t0 + 230, 70)],
               name="cudaLaunchKernel")
    return {"traceEvents": ev}


class _Workload:
    config = harness.load_json(harness.PB / "configs" / "liso_bev512.json")
    streams = 8


class _Record:
    def __init__(self, tv):
        self.trace, self.workload = tv, _Workload()


def test_replayed_flow_kernels_are_read_by_name():
    rec = _Record(trace.read_trace(_trace(), n_steps=2))
    # by operator, the replay's convolution is not seen; by name it is
    assert rec.trace.device_s(
        lambda s: "stream.flow" in s and "aten::convolution" in s) == 0.0
    flow_conv = _module("flow_conv_ms.stream").read(rec)
    assert abs(flow_conv - 45e-3) < 1e-12  # (5 + 40) us a step, in ms
    k2 = _module("corr_window_roofline.stream")
    least = yardstick.least_seconds(*k2.lookup_cost(rec.workload), "bf16")
    assert abs(k2.read(rec) - 100.0 * 4 * least / 120e-6) < 1e-9


def test_nothing_to_read():
    rec = _Record(None)
    assert _module("flow_conv_ms.stream").read(rec) is None
    assert _module("corr_window_roofline.stream").read(rec) is None
    empty = {"traceEvents": [{"cat": "user_annotation", "name": "pb.window",
                              "ts": 0, "dur": 10, "tid": 1}]}
    rec = _Record(trace.read_trace(empty, n_steps=1))
    assert _module("flow_conv_ms.stream").read(rec) is None
    assert _module("corr_window_roofline.stream").read(rec) is None


@pytest.mark.parametrize("grid", [512, 64])
def test_k2_cost_from_shapes_is_the_programs(grid):
    from liso_tpu_torch.ops.corr_fused import pool_f1_levels

    w = _Workload()
    w.config = {**w.config, "grid_size": grid}
    s = w.config["slim"]
    h = grid // s["downsample"]
    b, c = w.streams, s["corr_feature_dim"]
    fmap1 = torch.zeros(b, h, h, c)
    f1cat, levels = pool_f1_levels(fmap1, s["corr_levels"])
    f0 = fmap1.reshape(b, h * h, c).to(torch.bfloat16)
    coords = torch.zeros(b, 2, h * h)
    out = torch.empty(b, len(levels.shapes) * (2 * s["corr_radius"] + 2) ** 2,
                      h * h)
    want = yardstick.corr_window_cost(f0, f1cat, coords, levels,
                                      s["corr_radius"], out)()
    assert _module("corr_window_roofline.stream").lookup_cost(w) == want


def test_new_readers_are_listed_for_the_stream():
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("corr_window_roofline.stream", "flow_conv_ms.stream"):
        assert listed[name]["workloads"] == ["stream_b8"]
        assert listed[name]["moves"] == "stream_frames_per_s"
