"""Faults planted in the program's timed path, to show that the check
catches them: a step that returns its state unchanged (`stale_state`),
half of the batch left out (`half_batch`), and an answer altered where it
is produced (`altered`). Used by the tests (CPU, small sizes) and by
`portbench.readings --fault` (the card, the cells' sizes)."""
from __future__ import annotations

from contextlib import contextmanager

import torch

KINDS = ("stale_state", "half_batch", "altered")


@contextmanager
def _patch(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def stream_fault(kind: str):
    """`serve.fused_streaming` broken: the new frame's features not kept
    (the state stays the previous frame's), half the streams computed and
    copied over the rest, or one cell's flow a metre off."""
    from liso_tpu_torch import serve

    real = serve.fused_streaming

    def broken(slim, det, fmap_prev, cn_prev, pts, valid, plain=False):
        if kind == "half_batch":
            h = pts.shape[0] // 2
            out = real(slim, det, fmap_prev[:h], cn_prev[:h], pts[:h],
                       valid[:h], plain)
            return tuple(torch.cat([o, o[: pts.shape[0] - h]]) for o in out)
        fmap, cn, flow, pos, probs = real(slim, det, fmap_prev, cn_prev, pts,
                                          valid, plain)
        if kind == "stale_state":
            return fmap_prev, cn_prev, flow, pos, probs
        flow = flow.clone()
        flow[0, 10, 10] += 1.0
        return fmap, cn, flow, pos, probs

    return _patch(serve, "fused_streaming", broken)


def round_fault(kind: str):
    """The rounds loop's step broken: the update computed and not applied
    (parameters and AdamW's moments unchanged), the step on the first
    sample of the batch only (the loss is that sample's mean), or one
    pasted point a centimetre off."""
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    if kind == "stale_state":
        def update(self, losses, total):
            total.backward()
            self.count += 1
            self.step += 1
            return ({f"loss/{k}": v.detach() for k, v in losses.items()},
                    [p.grad for p in self.params.values()])
        return _patch(DetectorTrainer, "_update", update)
    if kind == "half_batch":
        real = DetectorTrainer.train_step

        def half(self, points, valid, target, *a, **kw):
            fields = ("pos", "dims", "rot", "probs", "velo", "valid",
                      "class_id", "difficulty")
            first = target.replace(**{f: getattr(target, f)[:1]
                                      for f in fields})
            return real(self, points[:1], valid[:1], first, *a, **kw)
        return _patch(DetectorTrainer, "train_step", half)
    real_prep = liso_loop.LisoSelfTraining._prepare_batch

    def altered(self, batch):
        pts, valid, target = real_prep(self, batch)
        pts = pts.clone()
        pts[0, 0, 0] += 0.01
        return pts, valid, target
    return _patch(liso_loop.LisoSelfTraining, "_prepare_batch", altered)


def plant(entry: str, kind: str):
    return {"stream": stream_fault, "round_step": round_fault}[entry](kind)
