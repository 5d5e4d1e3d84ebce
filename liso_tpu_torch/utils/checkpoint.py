"""Checkpoint save/restore of a train state (port of
liso_tpu/utils/checkpoint.py).

The JAX package writes through orbax, which the port cannot import, so the
port writes its own format: the trainer's `state_dict()` (parameters,
batch-norm statistics, optimizer moments and count, step, threshold state)
as one `torch.save` file, `<ckpt_dir>/<step>/state.pt`. The step-directory
layout that `latest_step` parses, the `format_version` file and its
warning, and the config sanity check are the JAX package's. Orbax
checkpoints written by JAX are not read here; a JAX state is carried across
by `liso_tpu_torch.weights.load_slim_train_state`.

A save is atomic, as orbax's is: the step directory is written under a
temporary name, which is not all digits, and renamed onto `<step>` once
`state.pt` is whole (`utils/atomic.publish`). A save that dies leaves
every earlier step as it was, and `latest_step` never names a partial
one, as it never names orbax's `*.orbax-checkpoint-tmp-*`.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Optional

import torch

from liso_tpu_torch.utils.atomic import publish, publish_text

# bump when trained-weight semantics change incompatibly; restore warns on
# older checkpoints. v2: corr window lookup switched from edge-clamping to
# the reference's zero padding + tap ordering (motion-encoder weights
# trained against v1 corr channels silently degrade).
FORMAT_VERSION = 2
STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir, step: int, trainer: Any) -> Path:
    """Write `trainer.state_dict()` as step `step`; a same-step resave
    replaces the earlier one only once it is whole."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    publish_text(ckpt_dir / "format_version", str(FORMAT_VERSION))

    def write(tmp):
        tmp.mkdir()
        torch.save(trainer.state_dict(), tmp / STATE_FILE)

    return publish(ckpt_dir / str(step), write)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: int, trainer: Any) -> Any:
    """Load step `step` into `trainer` (tensors onto its device, copied in
    place by its `load_state_dict`) and return the trainer."""
    ckpt_dir = Path(ckpt_dir).absolute()
    vfile = ckpt_dir / "format_version"
    saved_v = int(vfile.read_text()) if vfile.exists() else 1
    if saved_v != FORMAT_VERSION:
        print(
            f"WARNING: checkpoint format v{saved_v} != current "
            f"v{FORMAT_VERSION} — weights trained before a semantics "
            "change (see utils/checkpoint.FORMAT_VERSION) will run but "
            "may be silently degraded",
            file=sys.stderr,
        )
    state = torch.load(ckpt_dir / str(step) / STATE_FILE, weights_only=True,
                       map_location=trainer.device)
    trainer.load_state_dict(state)
    return trainer


def check_checkpoint_config_sanity(ckpt_dir, cfg, keys=(
    "network.name", "data.img_grid_size", "data.bev_range_m",
)):
    """The restored checkpoint must come from a compatible config
    (reference networks/simple_net/simple_net_utils.py
    load_checkpoint_check_sanity): compares the config.yml saved next to
    the checkpoints against the current run's config on the
    architecture-defining keys. Missing config.yml -> no-op (externally
    produced checkpoints)."""
    import yaml

    for cand in (Path(ckpt_dir) / "config.yml",
                 Path(ckpt_dir).parent / "config.yml"):
        if cand.exists():
            with open(cand) as f:
                saved = yaml.safe_load(f)
            break
    else:
        return True

    def dig(tree, dotted):
        node = tree
        for part in dotted.split("."):
            if isinstance(node, dict):
                node = node.get(part)
            else:
                node = getattr(node, part, None)
            if node is None:
                return None
        return node

    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        return v

    for dotted in keys:
        want = norm(dig(saved, dotted))
        got = norm(cfg.select(dotted) if hasattr(cfg, "select")
                   else dig(cfg, dotted))
        if want is not None and got is not None and want != got:
            raise ValueError(
                f"checkpoint config mismatch on {dotted}: "
                f"checkpoint={want!r} vs current={got!r}"
            )
    return True
