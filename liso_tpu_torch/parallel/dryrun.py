"""The multi-rank dry run (port of __graft_entry__.dryrun_multichip).

`dryrun_multichip(n)` spawns `n` ranks and runs, at the JAX dry run's
settings:
  * 5 SLIM train steps with the batch (n samples, one per rank) split over
    a process group, the loss falling;
  * 5 steps of the non-baseline CenterPoint the same way, the loss falling;
  * 5 steps each of TransFusion, PointPillars and PointRCNN the same way,
    each loss falling (the JAX dry run steps CenterPoint alone);
  * two workers of `LisoSelfTraining.run(total_steps=3)` over one shared log
    dir on a drive of two sequences: each mines its own sequence, both
    train on the merged DB in lock-step, and their parameters must end
    bitwise equal.
The workers are processes, not threads (the JAX run's threads share the
data pipeline's `dataset.epoch`). Everything runs on the card unless the
caller passes device="cpu"; without CUDA it raises.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from liso_tpu_torch.parallel.mesh import (
    RankProcesses,
    map_tree,
    shard_batch,
)
from liso_tpu_torch.serve import resolve_device

STEPS = 5
N_POINTS = 256


def _sharded_steps(group, device_type: str, n_devices: int) -> dict:
    """The SLIM step and every detector's step on this rank's shard;
    returns the loss curves (the global batch's, the same on every
    rank)."""
    from liso_tpu_torch.data.sample import FlowSample, PointCloud
    from liso_tpu_torch.losses.slim_loss import SlimLossCfg
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.ops.boxes import Boxes
    from liso_tpu_torch.train.detector_train import DetectorTrainer
    from liso_tpu_torch.train.pointpillars_train import PointPillarsTrainer
    from liso_tpu_torch.train.pointrcnn_train import PointRCNNTrainer
    from liso_tpu_torch.train.slim_train import SlimTrainer

    if device_type == "cpu":
        torch.set_num_threads(1)
    dev = torch.device(device_type)
    b, n = n_devices, N_POINTS
    bev = BevSetup(bev_range_m=(32.0, 32.0), grid_size=(32, 32))
    rng = np.random.RandomState(0)

    def cloud():
        return PointCloud(
            torch.from_numpy(rng.uniform(-14, 14, (b, n, 4)).astype(np.float32)),
            torch.ones((b, n), dtype=torch.bool))

    def to_shard(tree):
        return shard_batch(group, map_tree(lambda t: t.to(dev), tree))

    eye = torch.eye(4).expand(b, 4, 4).contiguous()
    batch = to_shard(FlowSample(cloud(), cloud(), eye, eye))
    slim = SlimTrainer(
        bev, num_iters=2, predict_weight_for_static_aggregation="sigmoid",
        use_static_aggr_flow_for_aggr_flow=True, loss_cfg=SlimLossCfg(),
        num_train_samples=8, warmup_steps=4, initial_lr=1e-5, train_steps=10,
        grad_clip_norm=1.0, group=group, device=dev)
    slim_losses = [float(slim.train_step(batch)["loss"]) for _ in range(STEPS)]

    pts = torch.from_numpy(rng.uniform(-14, 14, (b, n, 4)).astype(np.float32))
    target = Boxes.empty(4, batch=(b,))
    target.pos[:, 0] = torch.tensor([4.0, 2.0, -1.0])
    target.dims[:, 0] = torch.tensor([4.0, 2.0, 1.5])
    target.valid[:, 0] = True
    pts, valid, target = to_shard(
        (pts, torch.ones((b, n), dtype=torch.bool), target))
    det = DetectorTrainer(bev, total_steps=10, max_lr=1e-5,
                          use_baseline_parameters=False, group=group,
                          device=dev)
    det_losses = [float(det.train_step(pts, valid, target)["loss/total"])
                  for _ in range(STEPS)]
    others = {}
    for name, make in (
            ("transfusion", lambda: DetectorTrainer(
                bev, network="transfusion", total_steps=10, max_lr=1e-5,
                pre_max_boxes=100, group=group, device=dev)),
            ("pointpillars", lambda: PointPillarsTrainer(
                bev, total_steps=10, max_lr=1e-5, group=group, device=dev)),
            ("pointrcnn", lambda: PointRCNNTrainer(
                bev, total_steps=10, max_lr=1e-5, group=group, device=dev))):
        tr = make()
        others[name] = [float(tr.train_step(pts, valid, target)["loss/total"])
                        for _ in range(STEPS)]
    return {"slim": slim_losses, "det": det_losses, "others": others}


def _rounds_worker(group, device_type: str, log_dir: str) -> dict:
    """One worker of the rounds loop over the shared log dir (the group is
    not used: the workers meet through the log dir, as the JAX hosts do).
    Returns its shard's box count, the merged DB's, and its parameters."""
    import torch.distributed as dist

    from liso_tpu_torch.data.dataset import DataCfg
    from liso_tpu_torch.data.synthetic import SyntheticDataset
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.tracker.dbs import load_mined_boxes_db
    from liso_tpu_torch.train.liso_loop import LisoSelfTraining
    from liso_tpu_torch.utils.config import parse_config

    if device_type == "cpu":
        torch.set_num_threads(1)
    world, worker = dist.get_world_size(group), dist.get_rank(group)
    cfg = parse_config(
        Path(__file__).resolve().parent.parent / "config" / "liso_config.yml",
        extra_cfg_args=["centerpoint"],
        key_value_updates=[
            ["optimization", "rounds", "active", "true"],
            ["optimization", "rounds", "steps_per_round", "3"],
            ["optimization", "learning_rate", "0.001"],
            ["data", "batch_size", "2"],
            ["data", "num_workers", "0"],
            ["data", "tracking_cfg", "min_track_age", "2"],
            ["data", "tracking_cfg", "min_points_in_box", "5"],
            ["data", "tracking_cfg",
             "flow_cluster_detector_min_travel_dist_filter_m", "1.0"],
            ["validation", "val_every_n_steps", "0"],
        ],
    )
    dcfg = DataCfg(bev=BevSetup((40.0, 40.0), (64, 64)), n_max=4096,
                   m_max=12288, k_max_boxes=16, use_skip_frames="never")

    class TwoSeqSynthetic(SyntheticDataset):
        """The synthetic drive as 2 sequences, so that each worker mines a
        disjoint shard (seq_idx % world_size)."""

        num_sequences = 2

        def get_consecutive_sample_idxs_for_sequence(self, s):
            m = len(self) // 2
            return list(range(m)) if s % 2 == 0 else list(range(m, len(self)))

    loop = LisoSelfTraining(
        cfg, lambda db: TwoSeqSynthetic(dcfg, n_frames=8, mined_boxes_db=db),
        None, log_dir, data_cfg=dcfg, world_size=world, worker_id=worker,
        device=device_type)
    loop.run(total_steps=3)
    shard = load_mined_boxes_db(
        Path(log_dir) / "mined_round_0" / f"tracked_worker{worker}.npz")
    return {
        "shard_boxes": sum(len(v["track_id"]) for v in shard.values()),
        "shard_keys": sorted(shard),
        "merged_boxes": sum(len(v["track_id"]) for v in loop.mined_db.values()),
        "params": {k: v.detach().cpu() for k, v in loop.state.params.items()},
    }


def dryrun_multichip(n_devices: int, device=None, workdir=None) -> dict:
    """Run the dry run over `n_devices` gloo ranks (they share the one card,
    or the CPU) and check what the JAX dry run checks; returns the loss
    curves and the mined box counts. Raises AssertionError on a failed
    check. `workdir`: where the ranks' temporary files go (default: the
    system's temporary directory)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        # the sharded steps and the rounds workers run side by side
        step_ranks = RankProcesses(_sharded_steps, n_devices,
                                   (dev.type, n_devices), backend="gloo",
                                   workdir=tmp / "steps")
        try:
            workers = RankProcesses(_rounds_worker, 2,
                                    (dev.type, str(tmp / "shared")),
                                    backend="gloo",
                                    workdir=tmp / "rounds").join()
        finally:
            steps = step_ranks.join()
    slim, det = steps[0]["slim"], steps[0]["det"]
    for s in steps[1:]:
        if s != steps[0]:
            raise AssertionError(f"ranks disagree on the losses: {steps}")
    if not np.isfinite(slim).all() or not slim[-1] < slim[0]:
        raise AssertionError(f"sharded SLIM loss did not fall over "
                             f"{STEPS} steps: {slim}")
    others = steps[0]["others"]
    for name, curve in {"centerpoint": det, **others}.items():
        if not np.isfinite(curve).all() or not curve[-1] < curve[0]:
            raise AssertionError(f"sharded {name} loss did not fall over "
                                 f"{STEPS} steps: {curve}")
    per_worker = [w["shard_boxes"] for w in workers]
    merged = [w["merged_boxes"] for w in workers]
    if not merged[0] == merged[1] == sum(per_worker):
        raise AssertionError(f"merged DBs {merged}, shards {per_worker}")
    if not all(c > 0 for c in per_worker):
        raise AssertionError(f"a worker's shard mined nothing: {per_worker}")
    if set(workers[0]["shard_keys"]) & set(workers[1]["shard_keys"]):
        raise AssertionError("the mined shards overlap")
    p0, p1 = workers[0]["params"], workers[1]["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    if unequal or set(p0) != set(p1):
        raise AssertionError(f"replica parameters differ: {unequal}")
    print(f"dryrun_multichip({n_devices}) on {dev.type}: slim loss "
          f"{slim[0]:.4f}->{slim[-1]:.4f} ({STEPS} sharded steps), det loss "
          f"{det[0]:.4f}->{det[-1]:.4f}; rounds-loop sharded mining "
          f"{per_worker} -> merged {merged[0]} boxes on both workers, "
          f"replica params bit-identical")
    return {"slim_losses": slim, "det_losses": det, "other_losses": others,
            "shard_boxes": per_worker, "merged_boxes": merged[0]}
