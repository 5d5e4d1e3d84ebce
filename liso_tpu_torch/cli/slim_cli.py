"""SLIM training / flow-export CLI (port of liso_tpu/cli/slim_cli.py).

Behavioral reference: liso/slim/cli.py:12-64. Usage:
  python -m liso_tpu_torch.cli.slim_cli -c slim_liso kitti [--fast-test]
  python -m liso_tpu_torch.cli.slim_cli --inference-only --load_checkpoint DIR
The models run on the card; `--device cpu` runs them on the CPU.
"""
from __future__ import annotations

from pathlib import Path

from liso_tpu_torch.cli.common import (
    load_cfg_make_logdir,
    parse_cli_args,
    run_maybe_profiled,
)
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.ops.bev import BevSetup


def build_datasets(cfg, fast_test: bool, target: str = "flow"):
    """Source -> (train_ds, val_ds, bev) dispatch for all six dataset
    families (reference kabsch/main_utils.get_datasets:323-463). `target`
    selects the KITTI val split: 'flow' -> tracking (flow EPE eval),
    'object' -> object-detection split with ignore regions."""
    bev = BevSetup(tuple(cfg.data.bev_range_m), tuple(cfg.data.img_grid_size))
    n_max = 4096 if fast_test else 65536
    dcfg = DataCfg(
        bev=bev,
        n_max=n_max,
        m_max=2 * n_max,
        use_skip_frames=str(cfg.data.use_skip_frames),
        flow_source=str(cfg.data.flow_source),
        odom_source=str(cfg.data.odom_source),
    )
    source = str(cfg.data.source)
    if source in ("toy", "synthetic"):
        from liso_tpu_torch.data.synthetic import SyntheticDataset

        n_frames = 8 if fast_test else 64
        return (
            SyntheticDataset(dcfg, n_frames=n_frames, seed=0),
            SyntheticDataset(dcfg, n_frames=max(n_frames // 4, 2), seed=1),
            bev,
        )

    def _try(ctor, *a, **kw):
        try:
            return ctor(*a, **kw)
        except FileNotFoundError:
            return None

    if source == "kitti":
        from liso_tpu_torch.data.kitti import (
            KittiObjectDataset, KittiRawDataset, KittiTrackingDataset,
        )

        root = Path(cfg.data.paths.kitti.local)
        train = KittiRawDataset(dcfg, root)
        val_cls = (
            KittiObjectDataset if target == "object" else KittiTrackingDataset
        )
        return train, _try(val_cls, dcfg, root), bev
    if source == "nuscenes":
        from liso_tpu_torch.data.nuscenes import NuscenesDataset

        root = Path(cfg.data.paths.nuscenes.local)
        train = NuscenesDataset(dcfg, root, mode="train")
        return train, _try(NuscenesDataset, dcfg, root, mode="val"), bev
    if source == "waymo":
        from liso_tpu_torch.data.waymo import WaymoDataset

        root = Path(cfg.data.paths.waymo.local)
        ds_factor = int(
            getattr(cfg.data, "waymo_downsample_factor", 5) or 5
        )
        train = WaymoDataset(dcfg, root, downsample_factor=ds_factor)
        # no val/ subdir -> val_ds=None like the KITTI branch (callers skip
        # validation); silently validating on train frames would inflate
        # the metrics that gate model selection
        val = _try(
            WaymoDataset, dcfg, root / "val", downsample_factor=ds_factor
        )
        return train, val, bev
    if source == "av2":
        from liso_tpu_torch.data.waymo import AV2Dataset

        root = Path(cfg.data.paths.av2.local)
        train = AV2Dataset(dcfg, root)
        return train, _try(AV2Dataset, dcfg, root / "val"), bev
    raise NotImplementedError(source)


def make_train_dataset(cfg, dcfg, fast_test: bool, mined_db=None):
    """Rebuild the train dataset (optionally with a mined-box DB injected) —
    the loader-rebuild step of the reference rounds loop
    (liso_cli.py:317-327). No `augmentation` is passed, as in the JAX
    package, so the global SE(2) jitter stays off."""
    source = str(cfg.data.source)
    if source in ("toy", "synthetic"):
        from liso_tpu_torch.data.synthetic import SyntheticDataset

        n_frames = 8 if fast_test else 64
        return SyntheticDataset(
            dcfg, n_frames=n_frames, seed=0, mined_boxes_db=mined_db
        )
    if source == "kitti":
        from liso_tpu_torch.data.kitti import KittiRawDataset

        return KittiRawDataset(
            dcfg, Path(cfg.data.paths.kitti.local), mined_boxes_db=mined_db
        )
    if source == "nuscenes":
        from liso_tpu_torch.data.nuscenes import NuscenesDataset

        return NuscenesDataset(
            dcfg, Path(cfg.data.paths.nuscenes.local), mode="train",
            mined_boxes_db=mined_db,
        )
    if source == "waymo":
        from liso_tpu_torch.data.waymo import WaymoDataset

        return WaymoDataset(
            dcfg, Path(cfg.data.paths.waymo.local),
            downsample_factor=int(
                getattr(cfg.data, "waymo_downsample_factor", 5) or 5
            ),
            mined_boxes_db=mined_db,
        )
    if source == "av2":
        from liso_tpu_torch.data.waymo import AV2Dataset

        return AV2Dataset(
            dcfg, Path(cfg.data.paths.av2.local), mined_boxes_db=mined_db
        )
    raise NotImplementedError(source)


def main(argv=None):
    args = parse_cli_args(argv)
    if args.inference_only and not args.load_checkpoint:
        raise SystemExit("--inference-only needs --load_checkpoint")
    cfg, log_dir = load_cfg_make_logdir(args, "slim")
    train_ds, val_ds, bev = build_datasets(cfg, args.fast_test)

    from liso_tpu_torch.train.slim_experiment import SlimExperiment

    # the SLIM preset's anomaly toggle (cfg.SLIM.set_detect_anomaly) is
    # the trainer's non-finite check, set by slim_trainer_from_cfg
    exp = SlimExperiment(cfg, bev, train_ds, val_ds, log_dir,
                         device=args.device)
    if args.inference_only:
        exp.maybe_restore(args.load_checkpoint)
        n = exp.export_flow(
            train_ds,
            log_dir / "preds",
            world_size=args.world_size,
            worker_id=args.worker_id,
            max_samples=4 if args.fast_test else None,
        )
        print(f"exported flow for {n} samples to {log_dir / 'preds'}")
        return log_dir
    run_maybe_profiled(
        args, log_dir, lambda: exp.run(max_steps=3 if args.fast_test else None)
    )
    print(f"done; logs in {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
