"""SE(3) / SE(2) helpers (port of liso_tpu/ops/transforms.py).

Pose matrices are [..., 4, 4]; every function works on arbitrarily batched
inputs.
"""
from __future__ import annotations

import torch


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    """[...] yaw -> [..., 3, 3] rotation about +z."""
    c, s = torch.cos(theta), torch.sin(theta)
    zeros = torch.zeros_like(theta)
    ones = torch.ones_like(theta)
    rows = [
        torch.stack([c, -s, zeros], dim=-1),
        torch.stack([s, c, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def compose_matrix(t: torch.Tensor | None = None,
                   theta_z: torch.Tensor | None = None,
                   R: torch.Tensor | None = None) -> torch.Tensor:
    """[..., 4, 4] homogeneous pose from a translation [..., 3] and either
    a yaw [...] or a rotation [..., 3, 3]."""
    if R is None:
        if theta_z is None:
            raise ValueError("need theta_z or R")
        R = rot_z(theta_z)
    batch = R.shape[:-2]
    if t is None:
        t = R.new_zeros(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = R.new_zeros(batch + (1, 4))
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def decompose_matrix(T: torch.Tensor):
    """[..., 4, 4] -> (t [..., 3], yaw [...]), the rotation taken as one
    about z."""
    return T[..., :3, 3], torch.atan2(T[..., 1, 0], T[..., 0, 0])


def invert_pose(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: [R|t]^-1 = [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return compose_matrix(t=ti, R=Rt)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] poses to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def transform_flow(T: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Rotate [..., N, 3] flow vectors (no translation)."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], flow)


def homogenize_pcl(pts: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., N, 4] with w = 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z) unit quaternion, w >= 0:
    Shepperd's method, the construction of the largest of the four
    candidate diagonals."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    c0 = 1.0 + tr
    c1 = 1.0 + m00 - m11 - m22
    c2 = 1.0 + m11 - m00 - m22
    c3 = 1.0 + m22 - m00 - m11
    qs = torch.stack([
        torch.stack([c0, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, c1, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, c2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, c3], dim=-1),
    ], dim=-2)  # [..., 4, 4]
    cands = torch.stack([c0, c1, c2, c3], dim=-1)
    best = torch.argmax(cands, dim=-1, keepdim=True)
    q = torch.gather(qs, -2, best[..., None].expand(*best.shape, 4))[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.gather(cands, -1, best).clamp(min=1e-12)))
    return torch.where(q[..., :1] < 0, -q, q)

