"""Standalone evaluation CLI (port of liso_tpu/cli/eval_cli.py).

Behavioral reference: liso/eval/eval_ours.py:main:759-872 — evaluate a
trained detector checkpoint, a mined-box DB, the flow-cluster bootstrap, or
the echo_gt oracle through the same run_val metrics path.

  python -m liso_tpu_torch.cli.eval_cli -c kitti centerpoint \
      --load_checkpoint DIR            # trained detector (the port's format)
  python -m liso_tpu_torch.cli.eval_cli --mined_db tracked.npz ...
  python -m liso_tpu_torch.cli.eval_cli --override_network echo_gt ...

The detector, the flow-cluster bootstrap and the IoU matrices run on the
card; `--device cpu` runs them on the CPU. Each metric is printed as
`<key>: <value>` with the value's shortest round-trip repr, so two runs'
printouts are equal exactly when their metrics are.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from liso_tpu_torch.cli.common import load_cfg_make_logdir, parse_cli_args
from liso_tpu_torch.cli.slim_cli import build_datasets
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.eval.run_val import mined_db_predictor, run_val


def gt_echo_predictor(batch):
    """echo_gt oracle (simple_net.py:78-82): return the GT boxes."""
    return {k: np.asarray(v) for k, v in batch["gt_boxes"].items()}


def flow_cluster_predictor(bev, device):
    """The flow-cluster bootstrap per sample on `device`, at
    FlowClusterCfg's defaults (eval_cli.py:50-77)."""
    from liso_tpu_torch.models.flow_cluster_detector import (
        FlowClusterCfg,
        detect_boxes_from_flow,
    )
    from liso_tpu_torch.ops.bev import point_cell_ids

    fc_cfg = FlowClusterCfg()

    def predict(batch):
        outs = []
        for i in range(len(batch["sample_id"])):
            pcl = torch.as_tensor(batch["pcl_t0"][i], device=device)
            v = torch.as_tensor(batch["valid_t0"][i], device=device)
            cell, _, _ = point_cell_ids(pcl[:, :2], bev, v)
            outs.append(detect_boxes_from_flow(
                pcl, v, cell,
                torch.as_tensor(batch["flow_t0_t1"][i], device=device),
                torch.as_tensor(batch["odom_t0_t1"][i], dtype=torch.float32,
                                device=device),
                pcl, v, float(batch["time_delta_s"][i]), bev, fc_cfg,
            ))
        return {
            k: torch.stack([getattr(b, k) for b in outs]).cpu().numpy()
            for k in ("pos", "dims", "rot", "probs", "velo", "valid")
        }

    return predict


def main(argv=None):
    base = argparse.ArgumentParser(add_help=False)
    base.add_argument("--mined_db", default=None)
    base.add_argument("--override_network", default=None,
                      choices=[None, "echo_gt", "flow_cluster_detector"])
    extra, rest = base.parse_known_args(argv)
    args = parse_cli_args(rest)
    from liso_tpu_torch.serve import resolve_device

    device = resolve_device(args.device)
    cfg, log_dir = load_cfg_make_logdir(args, "eval")
    _, val_ds, bev = build_datasets(cfg, args.fast_test)
    if val_ds is None:
        raise SystemExit("no validation dataset for this source")
    loader = Prefetcher(val_ds, batch_size=1, shuffle=False, num_workers=2)

    if extra.mined_db:
        from liso_tpu_torch.tracker.dbs import load_mined_boxes_db

        predict = mined_db_predictor(load_mined_boxes_db(extra.mined_db))
    elif extra.override_network == "echo_gt":
        predict = gt_echo_predictor
    elif extra.override_network == "flow_cluster_detector":
        predict = flow_cluster_predictor(bev, device)
    else:
        from liso_tpu_torch.train.liso_loop import (
            LisoSelfTraining,
            detector_predictor,
        )

        loop = LisoSelfTraining(
            cfg, lambda db: val_ds, val_ds, log_dir, data_cfg=val_ds.cfg,
            device=device,
        )
        trainer = loop.trainer  # seeded init, as JAX's PRNGKey(0) state
        if args.load_checkpoint:
            from liso_tpu_torch.utils.checkpoint import (
                latest_step,
                restore_checkpoint,
            )

            step = latest_step(args.load_checkpoint)
            if step is None:
                raise SystemExit(f"no checkpoint under {args.load_checkpoint}")
            restore_checkpoint(args.load_checkpoint, step, trainer)
        predict = detector_predictor(trainer, device)

    family = str(cfg.data.source)
    class_names = {
        "kitti": ("Car", "Pedestrian", "Cyclist"),
        "nuscenes": None,  # wrapper uses the official class table
        "waymo": ("VEHICLE", "PEDESTRIAN", "CYCLIST"),
        "av2": ("REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST"),
    }.get(family)
    from liso_tpu_torch.utils.tb import TBFactory

    metrics = run_val(
        iter(loader), predict,
        moving_velocity_thresh=float(
            cfg.validation.obj_is_moving_velocity_thresh
        ),
        dataset_family=family,
        movable_class_names=class_names,
        kitti_annotated_fov_filter=(family == "kitti"),
        max_batches=4 if args.fast_test else None,
        writer=TBFactory(log_dir / "tb")("eval"),
        # 0 disables image panels (headless bulk eval)
        log_images_num_batches=int(
            getattr(cfg.logging, "max_log_img_batches", 2)
        ),
        bev_range_m=tuple(cfg.data.bev_range_m),
        # devkit-style per-class summary-plot PNGs next to the TB logs
        summary_plot_dir=log_dir / "plots",
        device=device,
    )
    for k in sorted(metrics):
        print(f"{k}: {float(metrics[k])!r}")
    return metrics


if __name__ == "__main__":
    main()
