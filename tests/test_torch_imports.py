"""The port stands alone: liso_tpu_torch and chip_smoke.py import nothing
of JAX and nothing of liso_tpu, and the entry points refuse to fall back
to the CPU when the card is missing."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "liso_tpu")

torch.set_num_threads(1)


def _port_files():
    return sorted((ROOT / "liso_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_liso_tpu_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_no_plain_parameter_above_ops():
    """The kernel-or-plain choice is `kernels.plain_versions()`, not an
    argument threaded through the layers: only the `ops/` wrappers, the
    kernel module and serve's entry points take a parameter `plain`."""
    pkg = ROOT / "liso_tpu_torch"
    allowed = (pkg / "ops", pkg / "kernels")
    found = []
    for path in sorted(pkg.rglob("*.py")):
        if path == pkg / "serve.py" or any(path.is_relative_to(d)
                                           for d in allowed):
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                a = node.args
                names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                if "plain" in names:
                    found.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not found, f"functions taking `plain`: {found}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'liso_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import liso_tpu_torch.serve, liso_tpu_torch.weights\n"
        "import liso_tpu_torch.train.slim_train\n"
        "import liso_tpu_torch.train.detector_train\n"
        "import liso_tpu_torch.data.centermaps, liso_tpu_torch.ops.nms\n"
        "import liso_tpu_torch.losses.centerpoint_loss\n"
        "import liso_tpu_torch.kernels\n"
        "import liso_tpu_torch.data.pipeline, liso_tpu_torch.data.synthetic\n"
        "import liso_tpu_torch.data.kitti, liso_tpu_torch.data.nuscenes\n"
        "import liso_tpu_torch.data.waymo, liso_tpu_torch.data.icp\n"
        "import liso_tpu_torch.data.ground, liso_tpu_torch.utils.checkpoint\n"
        "import liso_tpu_torch.train.slim_experiment\n"
        "import liso_tpu_torch.cli.slim_cli, liso_tpu_torch.visu.bbox_image\n"
        "import liso_tpu_torch.train.liso_loop, liso_tpu_torch.ops.soft_masks\n"
        "import liso_tpu_torch.visu.augm_db_image\n"
        "import liso_tpu_torch.eval.iou_oracle, liso_tpu_torch.eval.od_metrics\n"
        "import liso_tpu_torch.eval.waymo_metrics\n"
        "import liso_tpu_torch.eval.nuscenes_wrapper\n"
        "import liso_tpu_torch.eval.run_val, liso_tpu_torch.cli.eval_cli\n"
        "import liso_tpu_torch.utils.misc, liso_tpu_torch.utils.trace\n"
        "import liso_tpu_torch.data.augmentation\n"
        "import liso_tpu_torch.cli.liso_cli, liso_tpu_torch.cli.mining_cli\n"
        "import liso_tpu_torch.train.pointpillars_train\n"
        "import liso_tpu_torch.train.pointrcnn_train\n"
        "import liso_tpu_torch.models.transfusion\n"
        "import liso_tpu_torch.losses.hungarian_loss\n"
        "import liso_tpu_torch.ops.ball_query\n"
        "import liso_tpu_torch.models.time_reduce_conv\n"
        "import liso_tpu_torch.parallel.mesh, liso_tpu_torch.parallel.dryrun\n"
        "import liso_tpu_torch.models.torch_compat\n"
        "import liso_tpu_torch.visu.pcl_image\n"
        "import liso_tpu_torch.data.create_kitti\n"
        "import liso_tpu_torch.data.create_kitti_tracking\n"
        "import liso_tpu_torch.data.create_kitti_object\n"
        "import liso_tpu_torch.data.create_nuscenes\n"
        "import liso_tpu_torch.data.create_waymo\n"
        "import liso_tpu_torch.data.create_av2\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from liso_tpu_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_models(grid=32, num_iters=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_models(grid=32, num_iters=1, device="cuda")
    bev, slim, det = serve.build_models(grid=32, num_iters=1, device="cpu")
    assert next(slim.parameters()).device.type == "cpu"

    from liso_tpu_torch.train.slim_train import SlimTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlimTrainer(bev, num_iters=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlimTrainer(bev, num_iters=1, device="cuda")
    trainer = SlimTrainer(bev, num_iters=1, device="cpu")
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


def test_detector_trainer_refuses_cpu_fallback(monkeypatch):
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bev = BevSetup((40.0, 40.0), (32, 32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectorTrainer(bev)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectorTrainer(bev, device="cuda")
    trainer = DetectorTrainer(bev, device="cpu")
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    trainer = DetectorTrainer(bev, network="transfusion", device="cpu")
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    with pytest.raises(NotImplementedError):  # its own trainer
        DetectorTrainer(bev, network="pointpillars", device="cpu")


@pytest.mark.parametrize("which", ["pointpillars", "pointrcnn",
                                   "transfusion"])
def test_other_trainers_refuse_cpu_fallback(which, monkeypatch):
    """PointPillarsTrainer, PointRCNNTrainer and the transfusion
    DetectorTrainer build on the card unless device="cpu" is passed, and
    raise without CUDA."""
    import functools

    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.detector_train import DetectorTrainer
    from liso_tpu_torch.train.pointpillars_train import PointPillarsTrainer
    from liso_tpu_torch.train.pointrcnn_train import PointRCNNTrainer

    make = {"pointpillars": PointPillarsTrainer,
            "pointrcnn": PointRCNNTrainer,
            "transfusion": functools.partial(DetectorTrainer,
                                             network="transfusion")}[which]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bev = BevSetup((40.0, 40.0), (32, 32))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(bev, device=device)
    trainer = make(bev, device="cpu")
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    assert trainer.device.type == "cpu"


def test_detector_steps_pin_fp32(monkeypatch):
    """train_step and predict_step run with TF32 off whatever the caller
    set, and put the caller's settings back."""
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.ops.boxes import Boxes
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    trainer = DetectorTrainer(BevSetup((40.0, 40.0), (32, 32)), device="cpu")
    seen, forward = [], trainer.model.forward

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(*args, **kw)

    monkeypatch.setattr(trainer.model, "forward", spy)
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(2, 256, 4, generator=g) - 0.5) * 36
    valid = torch.ones(2, 256, dtype=torch.bool)
    trainer.train_step(pts, valid, Boxes.empty(4, batch=(2,)))
    trainer.predict_step(pts, valid)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_kernels_build_lazily():
    """Importing the kernel module builds and loads nothing."""
    from liso_tpu_torch import kernels

    assert kernels._loaded == {}
    assert set(kernels.launches) == {
        "grid_scatter_max_occ", "corr_window_fwd", "grid_gather",
        "grid_reduce_add_c1", "corr_window_bwd", "knn_banded",
        "grid_reduce_add", "scatter_max_vjp", "bn_relu_eval",
    }


def test_etl_and_visu_import_without_pyarrow_or_matplotlib():
    """The GPU machine has no pyarrow: the ETL modules and pcl_image import
    them only inside the functions that need them."""
    code = (
        "import sys\n"
        "for m in ('pyarrow', 'matplotlib', 'jax', 'liso_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import liso_tpu_torch.data.create_av2, liso_tpu_torch.visu.pcl_image\n"
        "import liso_tpu_torch.data.create_kitti\n"
        "import liso_tpu_torch.data.create_kitti_tracking\n"
        "import liso_tpu_torch.data.create_kitti_object\n"
        "import liso_tpu_torch.data.create_nuscenes\n"
        "import liso_tpu_torch.data.create_waymo\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
