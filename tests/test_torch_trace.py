"""The port's spans and counters (liso_tpu_torch/utils/trace.py): totals and
the ring, nesting, ranges in a torch.profiler trace (and out of the totals),
counters, threads, and the spans and counters that the program's layers
open: the loader's queue, the rounds loop's paste, the detector and SLIM
train steps, the streaming step. CPU, small shapes."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liso_tpu_torch import serve
from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.cli.slim_cli import make_train_dataset
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.data.synthetic import SyntheticDataset
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.train import liso_loop
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.train.slim_train import SlimTrainer, global_norm
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.config import parse_config
from test_torch_augmentation import augm_db

torch.set_num_threads(1)
GRID, RANGE, N_MAX = 64, 40.0, 2048
STREAM_SPANS = ("stream.pillars", "stream.encode", "stream.flow",
                "stream.detect")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def _calls(name):
    st = trace.stats(name)
    return st["calls"] if st else 0


def _chrome_trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_span_totals_and_ring():
    for ms in (1, 2, 3):
        with trace.span("t.sleep") as s:
            time.sleep(ms * 1e-3)
        assert s.seconds >= ms * 1e-3
    st = trace.stats("t.sleep")
    assert st["calls"] == 3 and len(st["ring_ms"]) == 3
    assert st["total_ms"] == pytest.approx(sum(st["ring_ms"]))
    assert st["mean_ms"] == pytest.approx(st["total_ms"] / 3)
    assert st["last_ms"] == st["ring_ms"][-1] >= 3
    # the ring keeps the last RING durations; the totals keep every call
    for _ in range(trace.RING + 10):
        with trace.span("t.many"):
            pass
    st = trace.stats("t.many")
    assert st["calls"] == trace.RING + 10 and len(st["ring_ms"]) == trace.RING
    assert trace.stats("t.never") is None


def test_nested_spans_time_their_own_blocks():
    with trace.span("t.outer") as outer:
        time.sleep(2e-3)
        with trace.span("t.inner") as inner:
            time.sleep(2e-3)
    assert outer.seconds > inner.seconds >= 2e-3
    assert _calls("t.outer") == _calls("t.inner") == 1
    snap = trace.snapshot()
    assert set(snap["spans"]) == {"t.outer", "t.inner"}
    assert snap["spans"]["t.outer"]["total_ms"] == pytest.approx(
        outer.seconds * 1e3)


def test_an_exception_closes_the_span():
    with pytest.raises(ValueError):
        with trace.span("t.raises"):
            raise ValueError("out")
    assert _calls("t.raises") == 1


def test_spans_under_the_profiler_are_ranges_and_out_of_the_totals(tmp_path):
    x = torch.randn(64, 64)
    with trace.span("t.outer"):  # one untraced call
        x @ x
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.outer", step=7) as outer:
            with trace.span("t.inner"):
                x @ x
    assert outer.seconds > 0
    assert _calls("t.outer") == 1 and _calls("t.inner") == 0
    assert trace.stats("t.inner")["last_ms"] > 0
    events = _chrome_trace(prof, tmp_path)
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation"}
    assert {"t.outer", "t.inner"} <= set(ranges)
    mm = [e for e in events if e.get("cat") == "cpu_op"
          and e["name"] == "aten::mm"]
    assert len(mm) == 1

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert inside(ranges["t.inner"], ranges["t.outer"])
    assert inside(mm[0], ranges["t.inner"])


def test_a_profiler_started_inside_a_span_keeps_it_out_of_the_totals():
    with trace.span("t.straddle"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("t.traced"):
                pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("t.straddle"):
            pass
    # the first call's profiler had stopped at its exit; the second's ran
    assert _calls("t.straddle") == 1
    assert _calls("t.traced") == 0


def test_counters():
    assert trace.counter("t.count") == 0 and trace.counter_ring("t.count") == []
    trace.count("t.count")
    trace.count("t.count", 4)
    trace.count("t.count", 0)
    assert trace.counter("t.count") == 5
    assert trace.counter_ring("t.count") == [1, 4, 0]
    assert trace.snapshot()["counters"] == {"t.count": 5}
    # the ring keeps the last RING increments; the total keeps every one
    for _ in range(trace.RING):
        trace.count("t.count", 2)
    assert trace.counter("t.count") == 5 + 2 * trace.RING
    assert trace.counter_ring("t.count") == [2] * trace.RING
    trace.reset()
    assert trace.counter("t.count") == 0 and trace.snapshot() == {
        "spans": {}, "counters": {}}
    assert trace.counter_ring("t.count") == []


def test_counts_under_the_profiler_are_left_out():
    """As a span's duration, a count made while a profiler records goes
    into neither the total nor the ring."""
    trace.count("t.count", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("t.count", 5)
    trace.count("t.count", 7)
    assert trace.counter("t.count") == 10
    assert trace.counter_ring("t.count") == [3, 7]


def test_worker_thread_spans_keep_their_own_name():
    """A producer thread's spans and the consumer's each keep their name's
    totals and ring, however their calls interleave."""
    def produce():
        for _ in range(50):
            with trace.span("t.produce"):
                time.sleep(1e-4)

    t = threading.Thread(target=produce)
    t.start()
    for _ in range(30):
        with trace.span("t.consume"):
            pass
    t.join(timeout=30)
    assert not t.is_alive()
    assert _calls("t.produce") == 50 and _calls("t.consume") == 30
    assert trace.stats("t.produce")["mean_ms"] > trace.stats("t.consume")["mean_ms"]


def test_many_threads_lose_no_update():
    """More threads than cores, each with a name of its own and one shared
    counter, with the interpreter switching threads as often as it can:
    every span call and every count is kept."""
    n_threads, n_calls = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_calls):
                with trace.span(f"t.thread{i}"):
                    trace.count("t.shared")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert trace.counter("t.shared") == n_threads * n_calls
    for i in range(n_threads):
        st = trace.stats(f"t.thread{i}")
        assert st["calls"] == n_calls and len(st["ring_ms"]) == trace.RING


class _Timed(SyntheticDataset):
    """A synthetic drive whose samples take `delay` seconds to assemble."""

    delay = 0.0

    def __getitem__(self, idx):
        time.sleep(self.delay)
        return super().__getitem__(idx)


@pytest.mark.parametrize("slow", ["loader", "consumer"])
def test_prefetcher_counts_an_empty_queue(slow):
    """A loader slower than its consumer finds the queue empty at nearly
    every batch; one faster than its consumer, at few."""
    dcfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX)
    ds = _Timed(dcfg, n_frames=10, seed=0, n_points=1500)
    ds.delay = 0.03 if slow == "loader" else 0.0
    loader = Prefetcher(ds, batch_size=1, shuffle=False, num_workers=1,
                        use_processes=False)
    try:
        n = 0
        for _ in loader:
            n += 1
            if slow == "consumer":
                time.sleep(0.1)
    finally:
        loader.close()
    assert n == trace.counter("data.batches") == _calls("data.produce")
    assert _calls("data.wait") == n + 1  # and the epoch's end
    empty = trace.counter("data.queue_empty")
    # one entry a batch in both rings, 0 or 1 in the empty queue's
    assert trace.counter_ring("data.batches") == [1] * n
    assert len(trace.counter_ring("data.queue_empty")) == n
    assert sum(trace.counter_ring("data.queue_empty")) == empty
    if slow == "loader":
        assert empty >= n - 1
    else:
        assert empty <= 2


@pytest.fixture(scope="module")
def rounds_loop(tmp_path_factory):
    cfg = parse_config(DEFAULT_CFG, ["centerpoint", "liso"],
                       [["data", "img_grid_size", f"[{GRID}, {GRID}]"],
                        ["data", "bev_range_m", f"[{RANGE}, {RANGE}]"]])
    dcfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX,
                   m_max=2 * N_MAX)
    loop = liso_loop.LisoSelfTraining(
        cfg, lambda db: None, None, tmp_path_factory.mktemp("loop"),
        data_cfg=dcfg, device="cpu")
    return loop, make_train_dataset(cfg, dcfg, True)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_batch_counts_what_it_pasted(rounds_loop, seed):
    loop, ds = rounds_loop
    batch = next(iter(Prefetcher(ds, batch_size=2, shuffle=True, seed=seed,
                                 num_workers=0)))
    # every 25th point: a sparse cloud leaves room for pasted boxes
    # (min_center_dist_from_occupied_m)
    batch["valid_t0"] &= np.arange(N_MAX) % 25 == 0
    loop._augm_db_final = augm_db(seed)
    loop.rng = np.random.RandomState(seed)
    trace.reset()
    pts, valid, target = loop._prepare_batch(batch)
    points = int(valid.sum()) - int(batch["valid_t0"].sum())
    boxes = int(target.valid.sum()) - int(batch["target_boxes"]["valid"].sum())
    assert points > 0 and boxes > 0
    assert trace.counter("det.points_pasted") == points
    assert trace.counter("det.boxes_pasted") == boxes
    assert _calls("det.paste") == _calls("det.h2d") == 1


def test_detector_step_spans_and_grad_norm(rounds_loop):
    """One CenterPoint step opens det.loss, det.backward and det.optimizer
    once each, and its grad_norm is the norm of the gradient it applied."""
    loop, ds = rounds_loop
    batch = next(iter(Prefetcher(ds, batch_size=2, shuffle=False,
                                 num_workers=0)))
    pts, valid, target = loop._prepare_batch(batch)
    trainer = DetectorTrainer(loop.bev, box_cfg=loop.box_cfg, device="cpu")
    trace.reset()
    metrics = trainer.train_step(pts, valid, target)
    for name in ("det.loss", "det.backward", "det.optimizer"):
        assert _calls(name) == 1, name
    grads = [p.grad for p in trainer.params.values() if p.grad is not None]
    assert torch.equal(metrics["grad_norm"], global_norm(grads))


def test_slim_step_spans():
    tt = SlimTrainer(BevSetup((RANGE, RANGE), (32, 32)), num_iters=1,
                     device="cpu")
    g = torch.Generator().manual_seed(3)
    pts = (torch.rand(1, 512, 4, generator=g) - 0.5) * 36
    valid = torch.ones(1, 512, dtype=torch.bool)
    eye = torch.eye(4)[None]
    tt.train_step(FlowSample(PointCloud(pts, valid),
                             PointCloud(pts + 0.3, valid), eye, eye))
    assert _calls("slim.loss_and_grads") == _calls("slim.optimizer") == 1


def test_slim_step_nests_forward_loss_backward_and_counts():
    """With the anomaly check on (the SLIM preset's), each step opens
    slim.forward, slim.loss and slim.backward once inside
    slim.loss_and_grads, their host times summing to within 10% of it;
    slim.points counts both clouds' valid points and slim.knn_queries the
    queries handed to the two 1-NN searches."""
    iters, n, n_valid1 = 2, 512, 400
    tt = SlimTrainer(BevSetup((RANGE, RANGE), (32, 32)), num_iters=iters,
                     use_static_aggr_flow_for_aggr_flow=True,
                     detect_anomaly=True, device="cpu")
    g = torch.Generator().manual_seed(5)
    pts = (torch.rand(1, n, 4, generator=g) - 0.5) * 36
    valid0 = torch.ones(1, n, dtype=torch.bool)
    valid1 = torch.arange(n)[None] < n_valid1
    eye = torch.eye(4)[None]
    batch = FlowSample(PointCloud(pts, valid0), PointCloud(pts + 0.3, valid1),
                       eye, eye)
    tt.train_step(batch)  # the first step's one-time costs stay out
    trace.reset()
    steps = 3
    for _ in range(steps):
        tt.train_step(batch)
    inner = ("slim.forward", "slim.loss", "slim.backward")
    for name in inner + ("slim.loss_and_grads", "slim.optimizer"):
        assert _calls(name) == steps, name
    outer = trace.stats("slim.loss_and_grads")["total_ms"]
    parts = sum(trace.stats(name)["total_ms"] for name in inner)
    assert 0.9 * outer <= parts <= outer
    assert trace.counter_ring("slim.points") == [n + n_valid1] * steps
    # aggregated, dynamic and static-aggregated flow, every iteration, each
    # direction's padded cloud
    assert trace.counter_ring("slim.knn_queries") == [3 * iters * 2 * n] * steps


def test_fused_streaming_opens_its_four_stages():
    _, slim, det = serve.build_models(grid=GRID, num_iters=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(1, 1024, 4, generator=g) - 0.5) * 90
    valid = torch.ones(1, 1024, dtype=torch.bool)
    fmap, cn = serve.encode(slim, pts, valid)
    for call in (1, 2):
        fmap, cn, *_ = serve.fused_streaming(slim, det, fmap, cn, pts, valid)
        assert [_calls(n) for n in STREAM_SPANS] == [call] * 4
