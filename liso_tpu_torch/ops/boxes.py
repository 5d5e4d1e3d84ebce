"""Fixed-capacity 3D box container (port of liso_tpu/ops/boxes.py: the
fields and the methods that detector training and NMS use; the pose and
point-membership methods come with mining).

  * pos  [..., K, 3]  box center
  * dims [..., K, 3]  (length_x, width_y, height_z)
  * rot  [..., K, 1]  yaw about +z
  * probs[..., K, 1]  confidence
  * velo [..., K, 1]  scalar speed along the box x-axis
  * valid[..., K]     bool slot mask
  * class_id [..., K, 1] int32 (UNKNOWN_CLASS_ID when not set)
  * difficulty [..., K, 1] int32

Invalid slots carry zeros, not NaN, so arithmetic on them stays finite;
consumers mask by `valid`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

UNKNOWN_CLASS_ID = torch.iinfo(torch.int32).max
INVALID_CLASS_ID = UNKNOWN_CLASS_ID - 1

_FIELDS = ("pos", "dims", "rot", "probs", "velo", "valid", "class_id",
           "difficulty")


@dataclasses.dataclass
class Boxes:
    pos: torch.Tensor
    dims: torch.Tensor
    rot: torch.Tensor
    probs: torch.Tensor
    valid: torch.Tensor
    velo: Optional[torch.Tensor] = None
    class_id: Optional[torch.Tensor] = None
    difficulty: Optional[torch.Tensor] = None

    @staticmethod
    def empty(k: int, batch: tuple = (), dtype=torch.float32,
              device=None) -> "Boxes":
        z = lambda c: torch.zeros(batch + (k, c), dtype=dtype, device=device)
        return Boxes(
            pos=z(3), dims=z(3), rot=z(1), probs=z(1), velo=z(1),
            valid=torch.zeros(batch + (k,), dtype=torch.bool, device=device),
            class_id=torch.full(batch + (k, 1), UNKNOWN_CLASS_ID,
                                dtype=torch.int32, device=device),
            difficulty=torch.zeros(batch + (k, 1), dtype=torch.int32,
                                   device=device),
        )

    def replace(self, **fields) -> "Boxes":
        return dataclasses.replace(self, **fields)

    def with_defaults(self) -> "Boxes":
        """Fill the optional fields so every Boxes has the same fields."""
        p = self.probs
        return dataclasses.replace(
            self,
            velo=self.velo if self.velo is not None else torch.zeros_like(p),
            class_id=(
                self.class_id
                if self.class_id is not None
                else torch.full(p.shape, UNKNOWN_CLASS_ID, dtype=torch.int32,
                                device=p.device)
            ),
            difficulty=(
                self.difficulty
                if self.difficulty is not None
                else torch.zeros(p.shape, dtype=torch.int32, device=p.device)
            ),
        )

    @property
    def k(self) -> int:
        return self.valid.shape[-1]

    def bev_corners(self) -> torch.Tensor:
        """[..., K, 4, 2] BEV footprint corners (ccw in box frame)."""
        lx = self.dims[..., 0] * 0.5
        wy = self.dims[..., 1] * 0.5
        cx = torch.stack([lx, -lx, -lx, lx], dim=-1)
        cy = torch.stack([wy, wy, -wy, -wy], dim=-1)
        c, s = torch.cos(self.rot[..., 0]), torch.sin(self.rot[..., 0])
        x = c[..., None] * cx - s[..., None] * cy + self.pos[..., 0:1]
        y = s[..., None] * cx + c[..., None] * cy + self.pos[..., 1:2]
        return torch.stack([x, y], dim=-1)

    def mask_invalid(self) -> "Boxes":
        """Zero the attributes of invalid slots (class ids become
        INVALID_CLASS_ID)."""
        m = self.valid[..., None]
        z = lambda x: None if x is None else torch.where(m, x, 0)
        return Boxes(
            pos=z(self.pos), dims=z(self.dims), rot=z(self.rot),
            probs=z(self.probs), velo=z(self.velo), valid=self.valid,
            class_id=None if self.class_id is None else torch.where(
                m, self.class_id, INVALID_CLASS_ID),
            difficulty=z(self.difficulty),
        )

    def concatenate(self, other: "Boxes") -> "Boxes":
        """Concatenate along the K axis."""
        a, b = self.with_defaults(), other.with_defaults()
        return Boxes(**{
            f: torch.cat([getattr(a, f), getattr(b, f)],
                         dim=-1 if f == "valid" else -2)
            for f in _FIELDS
        })

    def take(self, idx: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> "Boxes":
        """Gather box slots along K with an index tensor idx [..., K']."""
        a = self.with_defaults()
        idx = idx.long()

        def g(x):
            return torch.gather(
                x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))

        new_valid = torch.gather(a.valid, -1, idx)
        if valid is not None:
            new_valid = new_valid & valid
        return Boxes(**{f: g(getattr(a, f)) for f in _FIELDS if f != "valid"},
                     valid=new_valid)

    def pad_to(self, k: int) -> "Boxes":
        """Pad with empty slots (or truncate) the K axis to capacity k."""
        a = self.with_defaults()
        if a.k >= k:
            return Boxes(**{
                f: getattr(a, f)[..., :k] if f == "valid"
                else getattr(a, f)[..., :k, :] for f in _FIELDS
            })

        def pad(x, f):
            if f == "valid":
                return torch.nn.functional.pad(x, (0, k - a.k))
            return torch.nn.functional.pad(x, (0, 0, 0, k - a.k))

        return Boxes(**{f: pad(getattr(a, f), f) for f in _FIELDS})
