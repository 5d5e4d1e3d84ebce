"""LISO self-training CLI (port of liso_tpu/cli/liso_cli.py).

Behavioral reference: liso/kabsch/liso_cli.py:58-723. Usage mirrors the
reference:
  python -m liso_tpu_torch.cli.liso_cli -c kitti bev_100m_512 centerpoint \
      batch_size_four liso [--fast-test]
  ... --load_checkpoint <log dir>/ckpts [--finetune]
The detector runs on the card; `--device cpu` runs it on the CPU.
"""
from __future__ import annotations

from liso_tpu_torch.cli.common import (
    load_cfg_make_logdir,
    parse_cli_args,
    run_maybe_profiled,
)
from liso_tpu_torch.cli.slim_cli import build_datasets, make_train_dataset
from liso_tpu_torch.train.liso_loop import LisoSelfTraining


def main(argv=None):
    args = parse_cli_args(argv)
    cfg, log_dir = load_cfg_make_logdir(args, "liso")
    train_ds, val_ds, bev = build_datasets(
        cfg, args.fast_test, target="object"
    )
    dcfg = train_ds.cfg

    def factory(mined_db):
        return make_train_dataset(cfg, dcfg, args.fast_test, mined_db)

    # --world_size/--worker_id: multi-host rounds — mining shards sequences
    # across workers and merges DBs through the shared log_dir
    loop = LisoSelfTraining(
        cfg, factory, val_ds, log_dir, data_cfg=dcfg,
        world_size=args.world_size, worker_id=args.worker_id,
        device=args.device,
    )

    start_step = 0
    if args.load_checkpoint:
        # resume: restore net+optimizer+step and the newest mined DBs
        # (liso_cli.py:742-789); --finetune keeps only the weights
        step = loop.restore(args.load_checkpoint)
        if args.finetune:
            loop.trainer.reset_optimizer()
            loop.mined_db = None
            loop._augm_db_final = None
            print(f"finetune from step {step} (weights only)")
        else:
            # the checkpoint was written AFTER training `step`: continue
            # with the next one (re-running it would double-train the step
            # and, at round boundaries, re-mine the completed round)
            start_step = step + 1
            print(f"resuming after step {step}")

    run_maybe_profiled(
        args,
        log_dir,
        lambda: loop.run(
            total_steps=int(cfg.optimization.num_training_steps),
            fast_test=args.fast_test,
            start_step=start_step,
        ),
    )
    metrics = loop.validate(int(cfg.optimization.num_training_steps),
                            fast_test=args.fast_test)
    print({k: round(v, 4) for k, v in metrics.items() if "mAP" in k})
    print(f"done; logs in {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
