"""The plain reference of the rounds loop's step: the batch read from the
benchmark's own sample files and mined-box DB, the copy-paste replayed
with a frozen copy of the augmentation, and CenterPoint's train step in
fp32 (the centermap targets, the loss, AdamW as optax takes it under the
OneCycle schedule). It imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.augmentation import BoxAugmCfg, paste_boxes_into_sample
from portbench.reference.bev import BevSetup
from portbench.reference.box_decode import BoxPredictionCfg
from portbench.reference.centermaps import render_centermaps
from portbench.reference.centerpoint_loss import centerpoint_loss
from portbench.reference.models import RefBoxLearner, precision

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BOX_KEYS = ("pos", "dims", "rot", "probs", "velo")


def pad(arr: np.ndarray, n: int):
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    k = min(len(arr), n)
    out[:k] = arr[:k]
    valid = np.zeros(n, bool)
    valid[:k] = True
    return out, valid


def load_batch(files, mined_db: dict, n_max: int, k_max: int,
               bev_range_m, height_range_m):
    """The loader's batch as the reference reads it: each sample's t0
    cloud without its ground, inside the BEV and the pillars' height range,
    padded; its mined boxes (every box: the DB holds no box under the
    confidence threshold 0), confidence set to 1, padded to k_max."""
    pcl, valid = [], []
    targets = {k: [] for k in BOX_KEYS + ("valid",)}
    for f in files:
        content = np.load(f, allow_pickle=True).item()
        p = np.asarray(content["pcl_t0"], np.float32)
        g = np.asarray(content["is_ground_t0"], bool)
        half = 0.5 * np.asarray(bev_range_m, np.float64)
        keep = (~g & (np.abs(p[:, 0]) < half[0]) & (np.abs(p[:, 1]) < half[1])
                & (height_range_m[0] < p[:, 2]) & (p[:, 2] < height_range_m[1]))
        a, v = pad(p[keep], n_max)
        pcl.append(a)
        valid.append(v)
        raw = mined_db[content["name"]]["raw_box"]
        boxes = {k: np.asarray(raw[k], np.float32) for k in BOX_KEYS}
        boxes["probs"] = np.ones_like(boxes["probs"])
        for k in BOX_KEYS:
            targets[k].append(pad(boxes[k], k_max)[0])
        targets["valid"].append(pad(boxes["pos"], k_max)[1])
    return (np.stack(pcl), np.stack(valid),
            {k: np.stack(v) for k, v in targets.items()})


def paste(pcl, valid, targets, augm_db, rng, bev_range_m, cfg: BoxAugmCfg):
    """The rounds loop's copy-paste (`_prepare_batch`), sample by sample,
    on copies: pasted points appended, pasted boxes in the free slots."""
    pcl, valid = pcl.copy(), valid.copy()
    targets = {k: v.copy() for k, v in targets.items()}
    n_max = valid.shape[1]
    for i in range(valid.shape[0]):
        base = pcl[i][valid[i]]
        rows = np.zeros(len(base), np.int64)
        new, _, pasted = paste_boxes_into_sample(base, rows, augm_db, rng,
                                                 bev_range_m, cfg)
        pcl[i], valid[i] = pad(new, n_max)
        if len(pasted["pos"]):
            k_slots = targets["pos"].shape[1]
            kv = int(targets["valid"][i].sum())
            n_add = min(len(pasted["pos"]), k_slots - kv)
            for key in BOX_KEYS:
                targets[key][i, kv:kv + n_add] = pasted[key][:n_add]
            targets["valid"][i, kv:kv + n_add] = True
    return pcl, valid, targets


class Boxes:
    def __init__(self, d: dict, device):
        for k, v in d.items():
            setattr(self, k, torch.as_tensor(v).to(device))


def onecycle(max_lr: float, total_steps: int, step: int) -> float:
    """torch's OneCycleLR (cosine, pct_start 0.4, div 10, final div 10) at
    `step`, in fp32, held at its minimum past the end."""
    total = max(int(total_steps), 10)
    initial, low = max_lr / 10.0, max_lr / 100.0
    up = max(float(0.4 * total) - 1.0, 1.0)
    down = max(total - 1.0 - up, 1.0)
    s = torch.tensor(float(step), dtype=torch.float32)
    if float(s) <= up:
        pct = (s / up).clamp(0.0, 1.0)
        return float(max_lr + (initial - max_lr) * 0.5 * (1 + torch.cos(math.pi * pct)))
    pct = ((s - up) / down).clamp(0.0, 1.0)
    return float(low + (max_lr - low) * 0.5 * (1 + torch.cos(math.pi * pct)))


def adamw_(params, grads, mu, nu, count: int, lr: float, wd: float):
    c = torch.tensor(count + 1, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(ADAM_B1) ** c)
    bc2 = float(1 - torch.tensor(ADAM_B2) ** c)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) + wd * p
            p.add_(-lr * u)


def train_steps(state: dict, batches, bev: BevSetup, box_cfg: BoxPredictionCfg,
                max_lr: float, total_steps: int, weight_decay: float,
                device, kind: str = "fp32"):
    """CenterPoint's train step over `batches` [(pcl, valid, targets)] from
    `state`. Returns (loss terms of each step, the gradient of step 1 by
    leaf, the state after the last step)."""
    model = RefBoxLearner(bev, box_cfg, device=device)
    model.load_state_dict(state)
    model.train()
    params = dict(model.named_parameters())
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first_grad = [], None
    with precision(kind):
        for count, (pcl, valid, targets) in enumerate(batches):
            pts = torch.from_numpy(pcl).to(device)
            v = torch.from_numpy(valid).to(device)
            boxes = Boxes(targets, device)
            _, decoded, activated = model(pts, v)
            gt = render_centermaps(boxes, bev, tuple(decoded["probs"].shape[1:3]),
                                   box_cfg)
            terms = centerpoint_loss(
                decoded_pred_maps=decoded, raw_activated_maps=activated,
                gt_maps=gt, center_mask=gt["center_bool_mask"],
                rotation_method=box_cfg.rotation_method)
            for p in params.values():
                p.grad = None
            terms["total"].backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params.values()]
            if first_grad is None:
                first_grad = {k: g.detach().clone()
                              for k, g in zip(params, grads)}
            adamw_(list(params.values()), grads, list(mu.values()),
                   list(nu.values()), count,
                   onecycle(max_lr, total_steps, count), weight_decay)
            losses.append({k: float(t.detach()) for k, t in terms.items()})
    after = {k: t.detach().clone() for k, t in model.state_dict().items()}
    return losses, first_grad, after
