"""CLI plumbing shared by all entry points (port of liso_tpu/cli/common.py).

Behavioral reference: liso/utils/config_helper_helper.py:27-175
(parse_cli_args / load_handle_args_cfg_logdir) and the fast-test config
rewrite of liso/kabsch/liso_cli.py:97-121. Flags and log-dir naming
(summary_dir / cfg_hash[:5] / datetime) match the reference. The port adds
`--device` (the card, `cuda`, unless the caller asks for `cpu`), and
`--profile` traces with torch.profiler. The config's anomaly toggle is a
trainer option here (`SlimTrainer(detect_anomaly=...)`), not a global.
"""
from __future__ import annotations

import argparse
import random
import tempfile
from datetime import datetime
from pathlib import Path

import numpy as np

from liso_tpu_torch.utils.config import Config, get_config_hash, parse_config, save_config

DEFAULT_CFG = Path(__file__).parent.parent / "config" / "liso_config.yml"


def parse_cli_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default=str(DEFAULT_CFG))
    p.add_argument("-c", "--configs", nargs="*", default=[],
                   help="overlay names composed onto default")
    p.add_argument("-kv", "--key_value", nargs="+", action="append",
                   default=None, help="dotpath value updates")
    p.add_argument("--fast-test", dest="fast_test", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="shrink the run and capture a torch.profiler trace")
    p.add_argument("--cprofile", action="store_true",
                   help="shrink the run and dump cProfile stats")
    p.add_argument("--summary_dir", default=str(
        Path(tempfile.gettempdir()) / "liso_tpu_torch_logs"))
    p.add_argument("--log_dir", default=None,
                   help="this run's log dir (default: <summary_dir>/<exp>/"
                        "<config hash>/<time>); workers of one multi-worker "
                        "run share it")
    p.add_argument("--load_checkpoint", default=None)
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--inference-only", dest="inference_only",
                   action="store_true")
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--worker_id", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the models run: cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.world_size > args.worker_id:
        p.error(f"--worker_id {args.worker_id} needs --world_size > it")
    return args


def apply_profile(cfg: Config) -> Config:
    """config_helper_helper.py:34-66: shrink the run for a profiling
    session (few steps, no val/checkpoint churn)."""
    cfg.optimization.rounds.active = False
    cfg.optimization.num_training_steps = 20
    cfg.validation.val_every_n_steps = 10**9
    cfg.checkpoint.save_model_every = 10**9
    cfg.SLIM.iterations.train = 20
    cfg.SLIM.iterations.eval_every = 10**9
    cfg.SLIM.iterations.full_eval_every = 10**9
    return cfg


def run_maybe_profiled(args, log_dir, fn):
    """Wrap a CLI main body: --profile captures a torch.profiler trace
    (chrome trace json), --cprofile dumps host-side cProfile stats — the
    reference's --profile/--cprofile flags."""
    if getattr(args, "cprofile", False):
        import cProfile
        import pstats

        prof = cProfile.Profile()
        out = prof.runcall(fn)
        stats_path = str(Path(log_dir) / "cprofile.stats")
        prof.dump_stats(stats_path)
        pstats.Stats(prof).sort_stats("cumulative").print_stats(25)
        print(f"cProfile stats written to {stats_path}")
        return out
    if getattr(args, "profile", False):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if str(getattr(args, "device", "cpu")).startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        trace = str(Path(log_dir) / "torch_trace.json")
        with profile(activities=acts) as prof:
            out = fn()
        prof.export_chrome_trace(trace)
        print(f"torch.profiler trace written to {trace}")
        return out
    return fn()


def apply_fast_test(cfg: Config) -> Config:
    """liso_cli.py:97-121: shrink the run so every code path executes."""
    cfg.optimization.rounds.active = True
    cfg.optimization.rounds.steps_per_round = 3
    cfg.optimization.num_training_steps = 6
    cfg.validation.val_every_n_steps = 3
    cfg.validation.num_val_steps = 2
    cfg.validation.num_val_on_train_steps = 2
    cfg.checkpoint.save_model_every = 3
    cfg.logging.img_log_interval = 3
    cfg.data.num_workers = 2
    cfg.data.tracking_cfg.min_track_age = 2
    cfg.data.tracking_cfg.max_augm_db_size_mb = 1
    # reference fast-test mining budget (liso_cli.py:250-252)
    cfg.data.tracking_cfg.min_num_boxes = 2
    cfg.data.tracking_cfg.timeout_s = 60
    cfg.SLIM.iterations.train = 3
    cfg.SLIM.iterations.eval_every = 2
    cfg.SLIM.iterations.full_eval_every = 2
    return cfg


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def load_cfg_make_logdir(args, exp_name: str):
    cfg = parse_config(
        args.config_file, args.configs, args.key_value
    )
    if args.fast_test:
        cfg = apply_fast_test(cfg)
    if getattr(args, "profile", False) or getattr(args, "cprofile", False):
        cfg = apply_profile(cfg)
    set_seed(int(cfg.seed))
    cfg_hash = get_config_hash(cfg)[:5]
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = (Path(args.log_dir) if args.log_dir
               else Path(args.summary_dir) / exp_name / cfg_hash / stamp)
    log_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, log_dir / "config.yml")
    return cfg, log_dir
