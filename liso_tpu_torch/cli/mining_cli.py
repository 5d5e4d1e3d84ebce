"""Standalone pseudo-label mining / tracking CLI (port of
liso_tpu/cli/mining_cli.py).

Behavioral reference: liso/tracker/tracking.py:main:114 — mine boxes over
whole dataset sequences with either the flow-cluster bootstrap (no
checkpoint) or a trained detector (--load_checkpoint), save the mined +
augmentation DBs, evaluate the mined boxes through the exact run_val
metrics path, and write a tracked-sequence GIF. Usage:

  python -m liso_tpu_torch.cli.mining_cli -c kitti bev_100m_512 centerpoint \
      liso [--load_checkpoint DIR] [--world_size N --worker_id I] [--fast-test]

The detector, the bootstrap and the IoU matrices run on the card;
`--device cpu` runs them on the CPU.
"""
from __future__ import annotations

from liso_tpu_torch.cli.common import (
    load_cfg_make_logdir,
    parse_cli_args,
    run_maybe_profiled,
)
from liso_tpu_torch.cli.slim_cli import build_datasets, make_train_dataset
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.eval.run_val import mined_db_predictor, run_val
from liso_tpu_torch.train.liso_loop import LisoSelfTraining, one_pass


def _save_sequence_gif(loop, dataset, log_dir, max_frames: int = 20):
    """Tracked-boxes GIF of a mined sequence on disk (the mine() call logs
    the same frames as an animated TB summary, tracking.py:365-500, and
    caches them — reuse instead of re-rendering)."""
    from liso_tpu_torch.visu.bbox_image import save_tracking_gif

    images = getattr(loop, "_last_seq_frames", None)
    if not images:
        images = loop.render_sequence_frames(dataset, max_frames=max_frames)
    if images:
        return save_tracking_gif(images, log_dir / "tracked_sequence.gif")
    return None


def main(argv=None):
    args = parse_cli_args(argv)
    cfg, log_dir = load_cfg_make_logdir(args, "mining")
    train_ds, val_ds, bev = build_datasets(
        cfg, args.fast_test, target="object"
    )
    dcfg = train_ds.cfg

    def factory(mined_db):
        return make_train_dataset(cfg, dcfg, args.fast_test, mined_db)

    loop = LisoSelfTraining(cfg, factory, val_ds, log_dir, data_cfg=dcfg,
                            device=args.device)

    if args.load_checkpoint:
        # mine with the restored detector instead of the flow-cluster
        # bootstrap (tracking.py:697-732 uses the trained net per frame)
        step = loop.restore(args.load_checkpoint)
        loop.round_idx = 1  # force the detector mining path
        print(f"restored detector checkpoint at step {step}")

    def body():
        # gather=False: standalone mining workers publish their shard and
        # exit; DBs merge offline (each worker has its own log_dir). The
        # rounds loop (liso_cli) gathers in-process instead.
        loop.mine(
            train_ds, world_size=args.world_size, worker_id=args.worker_id,
            gather=False,
        )
        n_boxes = sum(
            len(v["track_id"]) for v in (loop.mined_db or {}).values()
        )
        # evaluate the mined DB through the run_val metrics path ON THE
        # MINED (train) SPLIT — mined boxes only exist for train samples
        # (tracking eval = run_val with the DB as predictor,
        # liso_cli.py:294-315)
        loader = Prefetcher(
            factory(None), batch_size=1, shuffle=False, num_workers=1
        )
        with one_pass(loader) as batches:
            metrics = run_val(
                batches,
                mined_db_predictor(loop.mined_db or {}),
                max_batches=4 if args.fast_test else None,
                device=loop.device,
            )
        headline = {
            k: round(float(v), 4)
            for k, v in metrics.items()
            if k.startswith(("mAP", "AP_overall_overall"))
        }
        print("mined-box eval:", headline)
        gif = _save_sequence_gif(loop, train_ds, log_dir)
        print(
            f"mined {n_boxes} boxes; DBs in "
            f"{log_dir / f'mined_round_{loop.round_idx}'}"
            + (f"; GIF {gif}" if gif else "")
        )
        return metrics

    run_maybe_profiled(args, log_dir, body)
    print(f"done; logs in {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
