"""`serve.fused_streaming`'s flow stage as a CUDA graph.

On the CPU (tier 1): CPU tensors and `plain=True` run the eager stage and
count `stream.flow_graph.eager`, nothing is captured, and
`serve.flow_graph_key` tells apart what a captured stage depends on.

Marked `cuda` (skips without an NVIDIA GPU), in bf16 and in fp32: chained
streaming steps with the graph against the same steps with the eager
stage, bitwise, and against the plain versions of the kernels on the same
inputs, within a tolerance; a second batch size, weights loaded in place
and a replaced parameter; the returned flow is the caller's own; the
launch and engagement counters. Run them on a GPU machine with
    python -m pytest --noconftest tests/test_torch_serve_graph.py -q
"""
import pytest
import torch

from liso_tpu_torch import kernels, serve
from liso_tpu_torch.utils import trace

GRID, ITERS, N, B = 64, 2, 2048, 2
COUNTERS = ("eager", "captures", "replays")


def _counts():
    return {c: trace.counter(f"stream.flow_graph.{c}") for c in COUNTERS}


def _delta(before):
    now = _counts()
    return {c: now[c] - before[c] for c in COUNTERS}


def _clouds(n_frames, batch, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand(n_frames, batch, N, 4, generator=g, device=device)
    pts[..., :2] = pts[..., :2] * 90 - 45
    pts[..., 2] = pts[..., 2] * 8 - 4
    valid = torch.rand(n_frames, batch, N, generator=g, device=device) > 0.05
    return pts, valid


# -- CPU --------------------------------------------------------------------
@pytest.fixture(scope="module")
def cpu_models():
    torch.set_num_threads(1)
    _, slim, det = serve.build_models(grid=GRID, num_iters=ITERS, device="cpu")
    return slim, det


@pytest.mark.parametrize("plain", [False, True])
def test_cpu_takes_the_eager_path(cpu_models, monkeypatch, plain):
    def no_capture(*a, **kw):
        raise AssertionError("a capture was attempted without CUDA")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_capture)
    monkeypatch.setattr(torch.cuda, "graph", no_capture)
    slim, det = cpu_models
    pts, valid = _clouds(3, B, "cpu")
    fmap, cn = serve.encode(slim, pts[0], valid[0])
    before = _counts()
    for t in (1, 2):
        fmap_prev, cn_prev = fmap, cn
        fmap, cn, flow, _, _ = serve.fused_streaming(
            slim, det, fmap_prev, cn_prev, pts[t], valid[t], plain=plain)
        with torch.inference_mode():
            want = slim.flow_from_features(fmap_prev, cn_prev, fmap)
        assert torch.equal(flow, want[-1][..., 4:6])
    assert _delta(before) == {"eager": 2, "captures": 0, "replays": 0}
    assert slim not in serve._flow_graphs


def _key_inputs(slim, batch=B, dtype=torch.float32, layout="encoder"):
    pts, valid = _clouds(2, batch, "cpu")
    fmap, cn = serve.encode(slim, pts[0], valid[0])
    fmap, cn = fmap.to(dtype), cn.to(dtype)
    if layout == "nchw":  # the same values, laid out channels-first
        fmap, cn = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                    for t in (fmap, cn))
    return fmap, cn, fmap


def test_flow_graph_key_is_stable(cpu_models):
    slim, _ = cpu_models
    a = serve.flow_graph_key(slim, *_key_inputs(slim))
    assert a == serve.flow_graph_key(slim, *_key_inputs(slim))
    # weights loaded in place keep the key: a replay reads the new values
    state = {k: v.clone() + 1 for k, v in slim.state_dict().items()}
    old = {k: v.clone() for k, v in slim.state_dict().items()}
    slim.load_state_dict(state)
    try:
        assert serve.flow_graph_key(slim, *_key_inputs(slim)) == a
    finally:
        slim.load_state_dict(old)


@pytest.mark.parametrize("change", ["batch", "dtype", "layout", "grid",
                                    "num_iters", "replaced_parameter"])
def test_flow_graph_key_tells_apart(cpu_models, change):
    slim, _ = cpu_models
    base = serve.flow_graph_key(slim, *_key_inputs(slim))
    if change == "batch":
        key = serve.flow_graph_key(slim, *_key_inputs(slim, batch=B + 1))
    elif change == "dtype":
        key = serve.flow_graph_key(slim, *_key_inputs(slim,
                                                      dtype=torch.bfloat16))
    elif change == "layout":
        key = serve.flow_graph_key(slim, *_key_inputs(slim,
                                                      layout="nchw"))
    elif change == "grid":
        fmap, cn, _ = _key_inputs(slim)
        half = (fmap[:, ::2], cn[:, ::2], fmap[:, ::2])
        key = serve.flow_graph_key(slim, *half)
    elif change == "num_iters":
        slim.raft.num_iters += 1
        try:
            key = serve.flow_graph_key(slim, *_key_inputs(slim))
        finally:
            slim.raft.num_iters -= 1
    else:
        conv = slim.raft.update_block.heads_conv1
        w = conv.weight
        conv.weight = torch.nn.Parameter(w.detach().clone())
        try:
            key = serve.flow_graph_key(slim, *_key_inputs(slim))
        finally:
            conv.weight = w
    assert key != base
    assert base == serve.flow_graph_key(slim, *_key_inputs(slim))


# -- the card ---------------------------------------------------------------
GPU_GRID, GPU_ITERS, GPU_STEPS = 128, 3, 4
# the replayed steps against the same steps through the plain versions of
# the kernels on the same inputs (flow in m). K2 rounds each corr to bf16,
# so a sum in another order moves some taps by a bf16 step. On an H100,
# clouds of seeds 1-3, the widest flow gap was 2.7e-3 m in fp32 and 0.023
# m in bf16; with K2's taps scaled by 1.01 in the graph it was 0.047 and
# 0.060, with one pixel's taps zeroed 0.68, with the coarsest level's
# taps zeroed 1.37 (flows up to 7.3 m). Each limit lies between.
PLAIN_FLOW_ATOL = {torch.float32: 1e-2, torch.bfloat16: 4e-2}
PLAIN_BOX_ATOL = 1e-3


@pytest.fixture(params=[torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    _, slim, det = serve.build_models(grid=GPU_GRID, num_iters=GPU_ITERS,
                                      compute_dtype=request.param, seed=0,
                                      device="cuda")
    pts, valid = _clouds(GPU_STEPS + 1, B, "cuda", seed=1)
    return slim, det, pts, valid


def _steps(slim, det, pts, valid, n=GPU_STEPS):
    """n chained steps: each step's (flow, pos, probs), a copy of its flow
    made right after it, its K2 launches and its (fmap_prev, cn_prev)."""
    fmap, cn = serve.encode(slim, pts[0], valid[0])
    outs, copies, k2, prevs = [], [], [], []
    for t in range(1, n + 1):
        prevs.append((fmap, cn))
        before = kernels.launches["corr_window_fwd"]
        fmap, cn, flow, pos, probs = serve.fused_streaming(
            slim, det, fmap, cn, pts[t], valid[t])
        torch.cuda.synchronize()
        k2.append(kernels.launches["corr_window_fwd"] - before)
        outs.append((flow, pos, probs))
        copies.append(flow.clone())
    return outs, copies, k2, prevs


def _eager_steps(slim, det, pts, valid, monkeypatch, n=GPU_STEPS):
    with monkeypatch.context() as m:
        m.setattr(serve, "_flow_stage", serve._eager_flow)
        return _steps(slim, det, pts, valid, n)[0]


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("flow", "pos", "probs")):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_graph_equals_eager_stage(card, monkeypatch):
    slim, det, pts, valid = card
    want = _eager_steps(slim, det, pts, valid, monkeypatch)
    before = _counts()
    got, copies, k2, prevs = _steps(slim, det, pts, valid)
    # the first step warms up, captures and replays; the rest replay
    assert _delta(before) == {"eager": 0, "captures": 1,
                              "replays": GPU_STEPS}
    # the warm-up launches K2 too; a capture launches nothing
    assert k2 == [2 * GPU_ITERS] + [GPU_ITERS] * (GPU_STEPS - 1)
    for g, w in zip(got, want):
        _assert_equal(g, w)
    # each step's flow is the caller's own: a later replay leaves it be
    for (flow, _, _), c in zip(got, copies):
        assert torch.equal(flow, c)
    # the eager path counts its launches as well
    with monkeypatch.context() as m:
        m.setattr(serve, "_flow_stage", serve._eager_flow)
        assert _steps(slim, det, pts, valid, 1)[2] == [GPU_ITERS]
    # each replayed step against the plain versions of the kernels on the
    # same inputs: a wrong K2 would be bitwise the same on both sides above
    flow_atol = PLAIN_FLOW_ATOL[slim.compute_dtype]
    for t, ((fmap_prev, cn_prev), g) in enumerate(zip(prevs, got), 1):
        _, _, *plain = serve.fused_streaming(
            slim, det, fmap_prev, cn_prev, pts[t], valid[t], plain=True)
        for a, b, tol, name in zip(g, plain,
                                   (flow_atol, PLAIN_BOX_ATOL, PLAIN_BOX_ATOL),
                                   ("flow", "pos", "probs")):
            gap = (a.float() - b.float()).abs().max().item()
            assert gap <= tol, (t, name, gap)


@pytest.mark.cuda
def test_graph_keys_and_weights(card, monkeypatch):
    slim, det, pts, valid = card
    _steps(slim, det, pts, valid, 2)  # captured at batch B
    key = serve._flow_graphs[slim][0]
    # a new batch size captures a graph in the old one's place
    one = (pts[:, :1], valid[:, :1])
    before = _counts()
    got1 = _steps(slim, det, *one, 2)[0]
    assert _delta(before) == {"eager": 0, "captures": 1, "replays": 2}
    assert serve._flow_graphs[slim][0] != key
    _assert_equal(got1[1], _eager_steps(slim, det, *one, monkeypatch, 2)[1])
    # back to batch B: captured again, then replayed
    before = _counts()
    got = _steps(slim, det, pts, valid, 2)[0]
    assert _delta(before) == {"eager": 0, "captures": 1, "replays": 2}
    assert serve._flow_graphs[slim][0] == key
    want = _eager_steps(slim, det, pts, valid, monkeypatch, 2)
    _assert_equal(got[1], want[1])

    # weights loaded in place show in the next replay
    _, other, _ = serve.build_models(grid=GPU_GRID, num_iters=GPU_ITERS,
                                     compute_dtype=slim.compute_dtype, seed=5,
                                     device="cuda")
    slim.load_state_dict(other.state_dict())
    before = _counts()
    got = _steps(slim, det, pts, valid, 2)[0]
    assert _delta(before) == {"eager": 0, "captures": 0, "replays": 2}
    new = _eager_steps(slim, det, pts, valid, monkeypatch, 2)
    _assert_equal(got[1], new[1])
    assert not torch.equal(new[1][0], want[1][0])

    # a replaced parameter is captured again
    conv = slim.raft.update_block.heads_conv1
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    before = _counts()
    got = _steps(slim, det, pts, valid, 3)[0]
    assert _delta(before) == {"eager": 0, "captures": 1, "replays": 3}
    _assert_equal(got[2], _eager_steps(slim, det, pts, valid, monkeypatch,
                                       3)[2])
