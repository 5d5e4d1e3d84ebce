"""Reading a Chrome trace: device events tied to the host ranges open at
their launch, busy time, and idle gaps labelled by the host's span."""
from portbench import readers, trace


def _trace():
    ev = []
    host = lambda name, ts, dur, tid=1, cat="cpu_op": ev.append(
        {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid})
    host("pb.window", 0, 100, cat="user_annotation")
    host("pb.prepare", 0, 30, cat="user_annotation")
    host("pb.train_step", 30, 60, cat="user_annotation")
    host("aten::convolution", 32, 5)
    host("pb.op.K1", 40, 4, cat="user_annotation")

    def launch(ts, corr, kts, kdur, name="k", tid=1):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": ts, "dur": 1, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": kts, "dur": kdur,
                   "tid": 7, "args": {"correlation": corr}})

    launch(33, 1, 35, 10, "conv_kernel")
    launch(41, 2, 50, 5, "scatter_kernel")
    launch(60, 3, 60, 20, "other")
    return {"traceEvents": ev}


def test_attribution_busy_and_gaps():
    tv = trace.read_trace(_trace(), n_steps=1)
    assert abs(tv.window_s - 100e-6) < 1e-12
    assert abs(tv.busy_s() - 35e-6) < 1e-12
    conv = tv.device_s(lambda s: "aten::convolution" in s)
    assert abs(conv - 10e-6) < 1e-12
    k1 = tv.device_s(lambda s: "pb.op.K1" in s)
    assert abs(k1 - 5e-6) < 1e-12
    gaps = dict((k, v) for k, v in tv.top_gaps())
    # 7 of the first gap's 8 probes fall in pb.prepare (0-30 us of 0-35)
    assert abs(gaps["pb.prepare>-"] - 7 * 35e-6 / 8) < 1e-12
    assert "pb.train_step>aten::convolution" in gaps
    assert tv.top_ops()[0][0] == "other"


class _Record:
    def __init__(self, tv):
        self.trace = tv
        self.device = {"busy_s": tv.busy_s(), "window_s": tv.window_s}
        self.op_costs = {"K1": [3.35e12 * 2.5e-6, 0.0, "fp32"]}


def test_readers():
    rec = _Record(trace.read_trace(_trace(), n_steps=1))
    assert abs(readers.conv_ms(rec) - 0.01) < 1e-9
    assert abs(readers.device_idle(rec) - 65.0) < 1e-9
    assert abs(readers.kernel_roofline(rec, ("K1", "K2")) - 50.0) < 1e-9
