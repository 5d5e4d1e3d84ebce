"""The one switch between the kernels and their plain PyTorch versions:
`kernels.use_plain` and the scope `kernels.plain_versions()`.

On the CPU (tier 1): the scope's depth on a tensor that no CPU rule
covers (`meta`): off outside, on inside and in a nested scope, off again
after an exception leaves it; `plain_versions(False)` opens nothing.

Marked `cuda` (skips without an NVIDIA GPU): a streaming step, a detector
train step and a SLIM train step inside the scope launch no kernel. Run it
on a GPU machine with
    python -m pytest --noconftest tests/test_torch_kernel_choice.py -q
"""
import pytest
import torch

from liso_tpu_torch import kernels

META = torch.empty(2, device="meta")


def test_plain_versions_scope():
    assert not kernels.use_plain(META)
    assert kernels.use_plain(META, plain=True)
    assert kernels.use_plain(torch.empty(2))  # a CPU tensor
    with kernels.plain_versions():
        assert kernels.use_plain(META)
        with kernels.plain_versions():
            assert kernels.use_plain(META)
        assert kernels.use_plain(META)
    assert not kernels.use_plain(META)
    with pytest.raises(ValueError, match="inside"):
        with kernels.plain_versions():
            assert kernels.use_plain(META)
            raise ValueError("inside")
    assert not kernels.use_plain(META)
    with kernels.plain_versions(False):
        assert not kernels.use_plain(META)


@pytest.mark.cuda
def test_scope_launches_no_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from liso_tpu_torch import serve
    from liso_tpu_torch.data.sample import FlowSample, PointCloud
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.ops.boxes import Boxes
    from liso_tpu_torch.train.detector_train import DetectorTrainer
    from liso_tpu_torch.train.slim_train import SlimTrainer

    g = torch.Generator(device="cuda").manual_seed(0)
    pts = (torch.rand(3, 2, 4096, 4, generator=g, device="cuda") - 0.5) * 36
    valid = torch.ones(2, 4096, dtype=torch.bool, device="cuda")
    bev = BevSetup((40.0, 40.0), (64, 64))
    _, slim, det = serve.build_models(grid=64, num_iters=2, device="cuda")
    detector = DetectorTrainer(bev, max_lr=1e-3, total_steps=100,
                               device="cuda")
    flow = SlimTrainer(bev, num_iters=2,
                       predict_weight_for_static_aggregation="sigmoid",
                       use_static_aggr_flow_for_aggr_flow=True, device="cuda")
    eye = torch.eye(4, device="cuda")[None]
    batch = FlowSample(PointCloud(pts[1, :1], valid[:1]),
                       PointCloud(pts[2, :1], valid[:1]), eye, eye)
    kernels.reset_launches()
    with kernels.plain_versions():
        fmap, cn = serve.encode(slim, pts[0], valid)
        serve.fused_streaming(slim, det, fmap, cn, pts[1], valid)
        detector.train_step(pts[0], valid, Boxes.empty(8, batch=(2,),
                                                       device="cuda"))
        flow.train_step(batch)
    torch.cuda.synchronize()
    assert kernels.launches == {k: 0 for k in kernels.launches}
    # outside the scope the same calls launch kernels again
    serve.fused_streaming(slim, det, fmap, cn, pts[1], valid)
    torch.cuda.synchronize()
    assert kernels.launches["bn_relu_eval"] > 0
    assert kernels.launches["grid_scatter_max_occ"] > 0
