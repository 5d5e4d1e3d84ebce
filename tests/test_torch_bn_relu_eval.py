"""Eval BatchNorm + ReLU in one pass (`models/layers.bn_relu_eval`, the
kernel `kernels/bn_relu_eval.cu`).

On the CPU (tier 1): `bn_relu_eval_plain` is relu(BatchNorm.forward(x)) in
both layouts and every dtype pair; `forward_relu` takes the composition on
the CPU, in train mode and with a gradient, and launches nothing; a
streaming step and `fused_forward` call it once for each of their 23 and
24 norms.

Marked `cuda` (skips without an NVIDIA GPU): the kernel bitwise against
the composition at the stream's shapes, ragged ones and special values; a
streaming step's features, boxes and probabilities bitwise with the kernel
and inside `kernels.plain_versions()`; its launch count per streaming step
and per train step. Run them on a GPU machine with
    python -m pytest --noconftest tests/test_torch_bn_relu_eval.py -q
"""
import pytest
import torch

from liso_tpu_torch import kernels, serve
from liso_tpu_torch.models import layers
from liso_tpu_torch.models.layers import BatchNorm, bn_relu_eval_plain
from liso_tpu_torch.models.pillar_encoder import MaskedBatchNorm

BF16, FP32 = torch.bfloat16, torch.float32
# BatchNorm layers one call runs: CenterPoint's 21 and a pillar encoder's
# norm per network and frame (SLIM encodes two frames in fused_forward)
STREAM_NORMS, FORWARD_NORMS = 23, 24


def _norm(c, dtype=None, channel_dim=1, device="cpu", seed=0, cls=BatchNorm):
    """A BatchNorm with random statistics and affine; some biases -0."""
    g = torch.Generator().manual_seed(seed)
    kw = {} if cls is MaskedBatchNorm else dict(dtype=dtype,
                                                channel_dim=channel_dim)
    bn = cls(c, **kw)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 1e-3)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g) * 0.5)
        bn.bias[::5] = -0.0
    return bn.to(device).eval()


def _input(shape, dtype, device="cpu", seed=1, special=True):
    """Signed random values; with `special`, NaN, +-inf, -0 and +0 spread
    over the channels."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3
    if special:
        flat = x.view(-1)
        vals = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0])
        idx = torch.randperm(flat.numel(), generator=g)[:5 * 7]
        flat[idx] = vals.repeat(7)
    return x.to(dtype).to(device)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _bitwise_equal(got, want):
    """Same dtype, shape, layout (strides) and bits."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.stride() == want.stride()
            and torch.equal(_bits(got), _bits(want)))


def _plain_args(bn):
    return (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
            bn.channel_dim, bn.dtype)


# -- CPU --------------------------------------------------------------------
LAYOUTS = [  # (shape, channel_dim, in dtype, BN dtype)
    ((2, 8, 5, 7), 1, BF16, BF16),
    ((2, 8, 5, 7), 1, FP32, None),
    ((2, 8, 5, 7), 1, BF16, None),
    ((2, 8, 5, 7), 1, FP32, BF16),
    ((2, 33, 12), -1, FP32, None),
    ((2, 33, 12), -1, BF16, BF16),
]


@pytest.mark.parametrize("shape,cd,dtype,bn_dtype", LAYOUTS)
def test_plain_is_relu_of_eval_forward(shape, cd, dtype, bn_dtype):
    bn = _norm(shape[cd], bn_dtype, cd)
    x = _input(shape, dtype)
    with torch.no_grad():
        want = torch.relu(bn(x))
        got = bn_relu_eval_plain(x, *_plain_args(bn))
        via = layers.bn_relu_eval(x, *_plain_args(bn))  # a CPU tensor
    assert _bitwise_equal(got, want)
    assert _bitwise_equal(via, want)
    assert got.dtype == (bn_dtype or FP32)


@pytest.fixture
def no_kernel(monkeypatch):
    """Fails on any attempt to load or launch a kernel; yields the launch
    counts before the test."""
    def refuse(name):
        raise AssertionError(f"kernel {name} requested on the CPU")

    monkeypatch.setattr(kernels, "function", refuse)
    return dict(kernels.launches)


@pytest.mark.parametrize("mode", ["eval_no_grad", "eval_grad", "train"])
@pytest.mark.parametrize("masked", [False, True], ids=["nchw", "pfn"])
def test_forward_relu_takes_the_composition_on_cpu(no_kernel, mode, masked):
    if masked:
        bn, x = _norm(16, cls=MaskedBatchNorm), _input((2, 40, 16), FP32,
                                                       special=False)
        mask = torch.arange(40)[None].expand(2, -1) % 3 > 0
    else:
        bn, x, mask = _norm(6, BF16), _input((2, 6, 4, 4), BF16,
                                             special=False), None
    bn.train(mode == "train")
    twin = _norm(bn.weight.numel(), BF16 if not masked else None,
                 cls=type(bn)).train(mode == "train")
    twin.load_state_dict(bn.state_dict())
    args = (x, mask) if masked else (x,)
    with torch.set_grad_enabled(mode != "eval_no_grad"):
        got = bn.forward_relu(*args)
        want = torch.relu(twin(*args))
    assert _bitwise_equal(got, want)
    assert got.requires_grad == (mode != "eval_no_grad")
    # train mode moved both twins' running statistics alike
    for a, b in zip(bn.buffers(), twin.buffers()):
        assert torch.equal(a, b)
    assert kernels.launches == no_kernel


def _spy_norms(monkeypatch):
    calls = []
    forward_relu = BatchNorm.forward_relu

    def spy(self, x):
        calls.append((type(self).__name__, tuple(x.shape), x.dtype))
        return forward_relu(self, x)

    monkeypatch.setattr(BatchNorm, "forward_relu", spy)
    return calls


def test_serving_calls_forward_relu_per_norm(monkeypatch):
    """A streaming step reaches `forward_relu` once for each of its 23
    norms (CenterPoint's 21 in bf16 NCHW, the two PFN norms in fp32), and
    `fused_forward` for its 24: the launches the card makes there."""
    torch.manual_seed(0)
    _, slim, det = serve.build_models(grid=64, num_iters=1,
                                      compute_dtype=BF16, device="cpu")
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 2, 512, 4, generator=g) * 90 - 45
    valid = torch.ones(2, 2, 512, dtype=torch.bool)
    fmap, cn = serve.encode(slim, pts[0], valid[0])
    calls = _spy_norms(monkeypatch)
    serve.fused_streaming(slim, det, fmap, cn, pts[1], valid[1])
    assert len(calls) == STREAM_NORMS
    assert [c[0] for c in calls[:2]] == ["MaskedBatchNorm"] * 2
    assert {c[2] for c in calls[:2]} == {FP32}
    assert {c[2] for c in calls[2:]} == {BF16}
    assert all(len(c[1]) == 4 for c in calls[2:])
    calls.clear()
    serve.fused_forward(slim, det, pts[0], valid[0], pts[1], valid[1])
    assert len(calls) == FORWARD_NORMS


# -- the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [  # (shape, channel_dim, in dtype, BN dtype)
    # the stream's CenterPoint shapes, bf16 -> bf16
    ((8, 64, 256, 256), 1, BF16, BF16),
    ((8, 128, 128, 128), 1, BF16, BF16),
    ((8, 256, 64, 64), 1, BF16, BF16),
    # fp32 -> fp32 (mining, validation), bf16 -> fp32, fp32 -> bf16
    ((2, 64, 256, 256), 1, FP32, None),
    ((2, 64, 64, 64), 1, BF16, None),
    ((2, 64, 64, 64), 1, FP32, BF16),
    # the pillar encoders' norm, fp32 channel-last
    ((8, 65536, 64), -1, FP32, None),
    # ragged: C = 3 and 67, H * W not a multiple of 8 (element by element)
    ((3, 3, 17, 19), 1, BF16, BF16),
    ((2, 67, 9, 7), 1, FP32, None),
    ((2, 67, 5, 3), 1, BF16, None),
    ((4, 1000, 3), -1, FP32, None),
    ((4, 1000, 67), -1, FP32, None),
    ((4, 1000, 67), -1, BF16, BF16),
    # channel-last wider than the kernel's shared memory holds
    ((3, 1100), -1, FP32, None),
    # a 1 x 1 map: inner 1, the channel-last walk
    ((5, 40, 1, 1), 1, BF16, BF16),
]
# NCHW maps held channels_last, as CenterPoint's are (its input is a
# channels-last image): the kernel walks them channel-last and keeps the
# layout, as the composition does
CHANNELS_LAST_CASES = [
    ((8, 64, 256, 256), 1, BF16, BF16),
    ((8, 256, 128, 128), 1, BF16, BF16),
    ((2, 67, 9, 7), 1, FP32, None),
    ((2, 3, 17, 19), 1, BF16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,cd,dtype,bn_dtype,layout",
    [(*c, torch.contiguous_format) for c in CARD_CASES]
    + [(*c, torch.channels_last) for c in CHANNELS_LAST_CASES])
def test_kernel_bitwise_vs_composition(card, shape, cd, dtype, bn_dtype,
                                       layout):
    bn = _norm(shape[cd], bn_dtype, cd, device=card)
    x = _input(shape, dtype, device=card).contiguous(memory_format=layout)
    before = kernels.launches["bn_relu_eval"]
    with torch.inference_mode():
        got = bn.forward_relu(x)
        want = bn_relu_eval_plain(x, *_plain_args(bn))
    torch.cuda.synchronize()
    assert kernels.launches["bn_relu_eval"] == before + 1
    assert _bitwise_equal(got, want)


@pytest.mark.cuda
def test_kernel_bitwise_on_a_strided_input(card):
    """A view that is not contiguous is made contiguous first; a slice
    whose start is not 16-byte aligned goes element by element."""
    bn = _norm(64, BF16, device=card)
    x = _input((4, 64, 33, 40), BF16, device=card)
    sliced = x[:, :, :, 1:33]
    shifted = x.view(-1)[1:1 + 3 * 64 * 33 * 40].view(3, 64, 33, 40)
    with torch.inference_mode():
        for v in (sliced, shifted):
            got = bn.forward_relu(v)
            assert _bitwise_equal(got, bn_relu_eval_plain(v, *_plain_args(bn)))


def _models(device, grid=128):
    _, slim, det = serve.build_models(grid=grid, num_iters=2,
                                      compute_dtype=BF16, seed=0,
                                      device=device)
    g = torch.Generator(device=device).manual_seed(1)
    pts = torch.rand(4, 2, 4096, 4, generator=g, device=device)
    pts[..., :2] = pts[..., :2] * 90 - 45
    pts[..., 2] = pts[..., 2] * 8 - 4
    valid = torch.rand(4, 2, 4096, generator=g, device=device) > 0.05
    return slim, det, pts, valid


def _stream(slim, det, pts, valid):
    """Three chained streaming steps: their (fmap, cn, pos, probs) and the
    kernel's launches in each."""
    fmap, cn = serve.encode(slim, pts[0], valid[0])
    outs, launches = [], []
    for t in range(1, pts.shape[0]):
        before = kernels.launches["bn_relu_eval"]
        fmap, cn, flow, pos, probs = serve.fused_streaming(
            slim, det, fmap, cn, pts[t], valid[t])
        torch.cuda.synchronize()
        launches.append(kernels.launches["bn_relu_eval"] - before)
        outs.append((fmap, cn, pos, probs))
    return outs, launches


@pytest.mark.cuda
def test_streaming_step_bitwise_with_the_composition(card):
    """Inside the scope every norm takes the composition, and K1 its plain
    version, which is bitwise the kernel: the features and the boxes match
    bitwise. The flow is not compared: K2 runs plain there too, and the
    flow stage has no norm and reads only the features compared.
    test_torch_serve_graph.py::test_graph_equals_eager_stage holds the
    flow of a run with this kernel bitwise to the eager stage's."""
    slim, det, pts, valid = _models(card)
    got, launches = _stream(slim, det, pts, valid)
    assert launches == [STREAM_NORMS] * (pts.shape[0] - 1)
    with kernels.plain_versions():
        want, none = _stream(slim, det, pts, valid)
    assert none == [0] * (pts.shape[0] - 1)
    for g, w in zip(got, want):
        for a, b, name in zip(g, w, ("fmap", "cn", "pos", "probs")):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_train_step_launches_none(card):
    """A detector train step runs its norms in train mode: no launch; its
    predict_step (eval, no gradient) launches one per norm."""
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.ops.boxes import Boxes
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    g = torch.Generator(device="cuda").manual_seed(0)
    pts = (torch.rand(2, 4096, 4, generator=g, device="cuda") - 0.5) * 36
    valid = torch.ones(2, 4096, dtype=torch.bool, device="cuda")
    target = Boxes.empty(8, batch=(2,), device="cuda")
    tr = DetectorTrainer(BevSetup((40.0, 40.0), (64, 64)), max_lr=1e-3,
                         total_steps=100, device="cuda")
    before = kernels.launches["bn_relu_eval"]
    tr.train_step(pts, valid, target)
    torch.cuda.synchronize()
    assert kernels.launches["bn_relu_eval"] == before
    norms = sum(isinstance(m, BatchNorm) for m in tr.model.modules())
    assert norms == STREAM_NORMS - 1  # CenterPoint's 21 and its PFN norm
    tr.predict_step(pts, valid)
    torch.cuda.synchronize()
    assert kernels.launches["bn_relu_eval"] == before + norms
