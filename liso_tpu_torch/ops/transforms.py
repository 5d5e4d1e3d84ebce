"""Rigid-transform helpers (port of the parts of liso_tpu/ops/transforms.py
that the SLIM loss uses)."""
from __future__ import annotations

import torch


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] poses to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def homogenize_pcl(pts: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., N, 4] with w = 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
