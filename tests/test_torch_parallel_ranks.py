"""Data and rank functions of tests/test_torch_parallel.py and
tests/test_torch_parallel_detectors.py (numpy and the port only: the ranks
are spawned processes, which import this module and never JAX). It holds no
test of its own.

The global batch is 2, one sample per rank, and the shards are unbalanced
on purpose: sample 1 has fewer valid points, fewer points inside a pillar
(its z spreads beyond the pillar's cut-off), hence less histogram mass in
the threshold update, and (for the detector) no target box at all.
"""
from __future__ import annotations

import numpy as np
import torch

from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.models.box_decode import BoxPredictionCfg
from liso_tpu_torch.models.layers import BatchNorm
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.parallel import mesh
from liso_tpu_torch.train import detector_train, slim_train
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.train.pointpillars_train import PointPillarsTrainer
from liso_tpu_torch.train.pointrcnn_train import PointRCNNTrainer
from liso_tpu_torch.train.slim_train import SlimTrainer

WORLD = 2
# SLIM at test_torch_slim_train's cut (grid 32 over 40 m, two RAFT
# iterations, the slim_liso flags), 1024 points a frame
S_GRID, S_RANGE, S_N = 32, 40.0, 1024
SLIM_CFG = dict(
    num_iters=2, predict_weight_for_static_aggregation="sigmoid",
    use_static_aggr_flow_for_aggr_flow=True, num_train_samples=10,
    warmup_steps=2, train_steps=10, initial_lr=1e-6,
)
# the detector at test_torch_detector_train's cut (grid 64 over 40 m)
D_GRID, D_RANGE, D_N, D_K = 64, 40.0, 1024, 8
DET_CFG = dict(max_lr=1e-5, total_steps=100, pre_max_boxes=200,
               post_max_boxes=40)
NETWORKS = ("baseline", "non_baseline")


def slim_bev():
    return BevSetup((S_RANGE, S_RANGE), (S_GRID, S_GRID))


def det_bev():
    return BevSetup((D_RANGE, D_RANGE), (D_GRID, D_GRID))


def slim_data(seed=0):
    """(p0, v0, p1, v1, eye) numpy: frame 1 is frame 0 moved by (0.6, -0.4)
    m with noise. Sample 1 keeps about half its points valid and spreads
    its z over +-8 m (the pillars cut at 5 m)."""
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-18, 18, (WORLD, S_N, 4)).astype(np.float32)
    p0[0, :, 2] = rng.uniform(-4, 4, S_N)
    p0[1, :, 2] = rng.uniform(-8, 8, S_N)
    p1 = p0 + rng.normal(0, 0.05, p0.shape).astype(np.float32)
    p1[..., :2] += np.array([0.6, -0.4], np.float32)
    v0, v1 = rng.rand(WORLD, S_N) > 0.05, rng.rand(WORLD, S_N) > 0.05
    v0[1] &= rng.rand(S_N) > 0.5
    v1[1] &= rng.rand(S_N) > 0.4
    eye = np.tile(np.eye(4, dtype=np.float32)[None], (WORLD, 1, 1))
    return p0, v0, p1, v1, eye


def slim_batch(data) -> FlowSample:
    p0, v0, p1, v1, eye = (torch.from_numpy(a) for a in data)
    return FlowSample(PointCloud(p0, v0), PointCloud(p1, v1), eye, eye)


def det_data(seed=0):
    """(pts, valid, boxes) numpy: background points and two dense
    box-shaped objects in sample 0 with their two target boxes; sample 1
    is background only, with no target box and 30% of its points invalid."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-18, 18, (WORLD, D_N, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 0.5, (WORLD, D_N))
    pts[..., 3] = rng.rand(WORLD, D_N)
    centers = np.array([[5.0, 2.0, -1.0], [-8.0, -3.0, -1.0]], np.float32)
    for j, c in enumerate(centers):
        sl = slice(j * 256, (j + 1) * 256)
        pts[0, sl, :3] = rng.uniform(-1, 1, (256, 3)) * [2.0, 1.0, 0.7] + c
    valid = rng.rand(WORLD, D_N) > 0.05
    valid[1] &= rng.rand(D_N) > 0.3
    boxes = {
        "pos": np.zeros((WORLD, D_K, 3), np.float32),
        "dims": np.zeros((WORLD, D_K, 3), np.float32),
        "rot": np.zeros((WORLD, D_K, 1), np.float32),
        "probs": np.zeros((WORLD, D_K, 1), np.float32),
        "velo": np.zeros((WORLD, D_K, 1), np.float32),
        "valid": np.zeros((WORLD, D_K), bool),
        "class_id": np.full((WORLD, D_K, 1), np.iinfo(np.int32).max, np.int32),
        "difficulty": np.zeros((WORLD, D_K, 1), np.int32),
    }
    boxes["pos"][0, :2] = centers
    boxes["dims"][0, :2] = [4.0, 2.0, 1.5]
    boxes["rot"][0, :2, 0] = rng.uniform(-0.3, 0.3, 2)
    boxes["probs"][0, :2] = 1.0
    boxes["valid"][0, :2] = True
    return pts, valid, boxes


def det_batch(data):
    pts, valid, boxes = data
    return (torch.from_numpy(pts), torch.from_numpy(valid),
            Boxes(**{k: torch.from_numpy(v) for k, v in boxes.items()}))


def slim_trainer(group=None) -> SlimTrainer:
    return SlimTrainer(slim_bev(), device="cpu", group=group, **SLIM_CFG)


def det_trainer(network: str, group=None) -> DetectorTrainer:
    return DetectorTrainer(det_bev(), device="cpu", group=group,
                           use_baseline_parameters=network == "baseline",
                           **DET_CFG)


class GradRecorder:
    """Keeps the gradient a trainer's step updates with: the list that
    `module.all_sum_` returns (the summed gradient) under a group."""

    def __init__(self, module):
        self.module, self.grads = module, None
        self._orig = module.all_sum_
        module.all_sum_ = self

    def __call__(self, tensors, group):
        self.grads = [g.clone() for g in self._orig(tensors, group)]
        return self.grads

    def close(self):
        self.module.all_sum_ = self._orig


def step_result(trainer, metrics, grads) -> dict:
    """What the tests compare after one step: the metrics, the gradient and
    the update by parameter name, the optimizer moments, the model's
    buffers (BN running statistics) and, for SLIM, the threshold state."""
    names = list(trainer.params)
    out = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": dict(zip(names, (g.detach().clone() for g in grads))),
        "params": {k: p.detach().clone() for k, p in trainer.params.items()},
        "nu": {k: v.clone() for k, v in trainer.nu.items()},
        "buffers": {k: v.clone() for k, v in trainer.model.named_buffers()},
    }
    if hasattr(trainer, "movavg"):
        out["movavg"] = {k: v.clone() for k, v in trainer.movavg._asdict().items()}
    return out


def run_slim_step(trainer, batch) -> dict:
    """One step; the gradient it used (summed over the group, or the local
    one)."""
    rec = GradRecorder(slim_train)
    try:
        metrics = trainer.train_step(batch)
    finally:
        rec.close()
    grads = rec.grads or [p.grad for p in trainer.params.values()]
    return step_result(trainer, metrics, grads)


def run_det_step(trainer, batch) -> dict:
    rec = GradRecorder(detector_train)
    try:
        metrics = trainer.train_step(*batch)
    finally:
        rec.close()
    grads = rec.grads or [p.grad for p in trainer.params.values()]
    return step_result(trainer, metrics, grads)


def helper_cases(group) -> dict:
    """shard_batch's rows and its error, replicate, and the cotangent rule
    of batch_sum, on this rank."""
    r = torch.distributed.get_rank(group)
    tree = {"x": torch.arange(12).reshape(6, 2),
            "pc": PointCloud(torch.arange(6.0), torch.ones(6, dtype=torch.bool)),
            "none": None}
    shard = mesh.shard_batch(group, tree)
    try:
        mesh.shard_batch(group, torch.zeros(5, 3))
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    state = {"w": torch.full((3,), float(r)), "n": [torch.tensor(r)], "k": r}
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(r)
    mesh.replicate(group, state)
    mesh.replicate(group, module)
    x = torch.tensor(float(r + 1), requires_grad=True)
    y = mesh.batch_sum(x, group)
    (y * (r + 1)).backward()
    return {"shard": shard, "indivisible": indivisible, "state": state,
            "weight": module.weight.detach().clone(), "sum": float(y),
            "sum_grad": float(x.grad)}


def refusals(group) -> dict:
    """For each of the trainers that once refused a group: the message it
    raises with (None when it builds), and whether every BatchNorm of its
    model took the group."""
    out = {}
    for name in OTHER_NETWORKS:
        try:
            tr = other_trainer(name, group)
            bns = [m for m in tr.model.modules()
                   if isinstance(m, BatchNorm)]
            out[name] = (None, bool(bns) and all(m.group is group
                                                 for m in bns))
        except NotImplementedError as e:
            out[name] = (str(e), False)
    return out


def run_cases(group, slim_state, det_states) -> dict:
    """Every case on this rank: the helpers, the refusals, one SLIM step
    and one step of each CenterPoint from the given states, on this rank's
    shard of the global batch."""
    torch.set_num_threads(1)
    out = {"helpers": helper_cases(group), "refusals": refusals(group)}
    st = slim_trainer(group)
    st.load_state_dict(slim_state)
    out["slim"] = run_slim_step(st, mesh.shard_batch(group,
                                                     slim_batch(slim_data())))
    for net in NETWORKS:
        dt = det_trainer(net, group)
        dt.load_state_dict(det_states[net])
        out[net] = run_det_step(dt, mesh.shard_batch(group,
                                                     det_batch(det_data())))
    return out


# ---------------------------------------------------------------------------
# TransFusion, PointPillars and PointRCNN (test_torch_parallel_detectors.py)
# ---------------------------------------------------------------------------
OTHER_NETWORKS = ("transfusion", "pointpillars", "pointrcnn")
# the transfusion preset's box prediction (liso_config.yml:549-566 with
# predict_rot_as_vector), as tests/test_torch_transfusion.py
TF_BOX = dict(position_method="global_absolute",
              dimensions_method="predict_abs_size", rotation_method="vector",
              activations={"pos": "none", "rot": "none", "dims": "none",
                           "probs": "none"})
TF_LAYERS = 2
OTHER_CFG = dict(max_lr=1e-5, total_steps=100, post_max_boxes=40)
# PointPillars' force-match takes each GT's best anchor, a rounding where
# two anchors lie within fp32 noise: the scene is moved by PP_SHIFT_M so
# that every GT's best anchor leads its second by more than 1e-3
# (tests/test_torch_pointpillars.py)
PP_SHIFT_M = 0.2
# PointRCNN: one more target box in each sample near the proposals of the
# random net of the test's seed, which gathers them at a corner of the
# cloud, so that both stages' Hungarian terms have matches (none with the
# first proposal: the reference's padded rows would clear it)
PR_EXTRA = ((-17.0, 18.0), (-19.5, 18.5))


def other_trainer(net: str, group=None):
    if net == "transfusion":
        return DetectorTrainer(det_bev(), network="transfusion",
                               box_cfg=BoxPredictionCfg(**TF_BOX),
                               num_decoder_layers=TF_LAYERS,
                               pre_max_boxes=200, device="cpu", group=group,
                               **OTHER_CFG)
    if net == "pointpillars":
        return PointPillarsTrainer(det_bev(), device="cpu", group=group,
                                   **OTHER_CFG)
    return PointRCNNTrainer(det_bev(), device="cpu", group=group,
                            **OTHER_CFG)


def other_data(net: str):
    """det_data's unbalanced batch (sample 0: two objects and their boxes;
    sample 1: background, 30% of its points invalid, no box), moved for
    PointPillars, and with one more box a sample for PointRCNN (so sample
    0 holds 3 boxes and sample 1 one)."""
    pts, valid, boxes = det_data()
    if net == "pointpillars":
        pts[..., :2] += PP_SHIFT_M
        boxes["pos"][0, :2, :2] += PP_SHIFT_M
    if net == "pointrcnn":
        for i, (x, y) in enumerate(PR_EXTRA):
            j = int(boxes["valid"][i].sum())
            boxes["pos"][i, j] = [x, y, -1.0]
            boxes["dims"][i, j] = [4.0, 2.0, 1.5]
            boxes["rot"][i, j] = 0.1
            boxes["probs"][i, j] = 1.0
            boxes["valid"][i, j] = True
    return pts, valid, boxes


def run_other_cases(group, states) -> dict:
    """One step of each of TransFusion, PointPillars and PointRCNN from the
    given states, on this rank's shard."""
    torch.set_num_threads(1)
    out = {}
    for net in OTHER_NETWORKS:
        tr = other_trainer(net, group)
        tr.load_state_dict(states[net])
        out[net] = run_det_step(tr, mesh.shard_batch(
            group, det_batch(other_data(net))))
    return out
