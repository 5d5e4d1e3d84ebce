"""Fixed-capacity 3D box container (port of liso_tpu/ops/boxes.py).

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

import numpy as np
import torch

from liso_tpu_torch.ops import transforms as tr

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

    @property
    def batch_shape(self):
        return self.valid.shape[:-1]

    def poses(self) -> torch.Tensor:
        """[..., K, 4, 4] sensor_T_box."""
        return tr.compose_matrix(t=self.pos, theta_z=self.rot[..., 0])

    def transform(self, new_T_old: torch.Tensor) -> "Boxes":
        """Move the boxes to a new frame; new_T_old [..., 4, 4] is broadcast
        over K."""
        pos, yaw = tr.decompose_matrix(new_T_old[..., None, :, :] @ self.poses())
        return self.replace(pos=pos, rot=yaw[..., None])

    def points_in_box_mask(self, pcl: torch.Tensor, bloat: float = 1.0,
                           return_box_coords: bool = False):
        """[..., N, 3] points -> [..., N, K] bool membership; invalid boxes
        hold no point. With return_box_coords also the points in every
        box's frame [..., N, K, 3]."""
        box_T_sensor = tr.invert_pose(self.poses())  # [..., K, 4, 4]
        R = box_T_sensor[..., :3, :3]
        t = box_T_sensor[..., :3, 3]
        p_box = (torch.einsum("...kij,...nj->...nki", R, pcl[..., :3])
                 + t[..., None, :, :])
        inside = torch.all(
            p_box.abs() < 0.5 * bloat * self.dims[..., None, :, :], dim=-1)
        inside = inside & self.valid[..., None, :]
        if return_box_coords:
            return inside, p_box
        return inside

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

    def corners(self) -> torch.Tensor:
        """[..., K, 8, 3] 3D corners (bottom 4 then top 4)."""
        bev = self.bev_corners()  # [..., K, 4, 2]
        z_lo = self.pos[..., 2:3] - 0.5 * self.dims[..., 2:3]
        z_hi = self.pos[..., 2:3] + 0.5 * self.dims[..., 2:3]
        lo = torch.cat([bev, z_lo[..., None, :].expand(*bev.shape[:-1], 1)], -1)
        hi = torch.cat([bev, z_hi[..., None, :].expand(*bev.shape[:-1], 1)], -1)
        return torch.cat([lo, hi], dim=-2)

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


def boxes_from_numpy(d: dict, device=None) -> Boxes:
    """Boxes from a dict of numpy arrays (the mined-DB and dataset
    format)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Boxes(
        pos=f32(d["pos"]), dims=f32(d["dims"]), rot=f32(d["rot"]),
        probs=f32(d["probs"]),
        velo=f32(d["velo"]) if d.get("velo") is not None else None,
        valid=torch.as_tensor(np.asarray(d["valid"], bool), device=device),
        class_id=torch.as_tensor(np.asarray(d["class_id"], np.int32),
                                 device=device)
        if d.get("class_id") is not None else None,
    ).with_defaults()
