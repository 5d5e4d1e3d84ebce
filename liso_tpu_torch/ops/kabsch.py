"""Differentiable weighted Kabsch rigid alignment (port of
liso_tpu/ops/kabsch.py), in fp32.

`symmetric_orthogonalization` takes the SVD of its 3x3 inputs with
`torch.linalg.svd` and differentiates with the hand-derived UV^T backward
of the reference (liso_tpu/ops/kabsch.py:27-48), not torch's generic SVD
gradient, whose 1/(d_i - d_j) terms are singular at repeated singular
values.
"""
from __future__ import annotations

import torch

EPSILON = 1e-7


class _SymmetricOrthogonalization(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        U, D, Vh = torch.linalg.svd(A)
        ctx.save_for_backward(U, D, Vh)
        return U @ Vh

    @staticmethod
    def backward(ctx, gR):
        U, D, Vh = ctx.saved_tensors
        n = D.shape[-1]
        # +eye keeps the diagonal denominators away from zero
        dl_plus_dk = (D[..., :, None] + D[..., None, :]
                      + torch.eye(n, dtype=D.dtype, device=D.device))
        V = Vh.transpose(-1, -2)
        omega = (
            U[..., :, None, :, None] * V[..., None, :, None, :]
            - U[..., :, None, None, :] * V[..., None, :, :, None]
        ) / dl_plus_dk[..., None, None, :, :]
        dR_dA = U[..., None, None, :, :] @ omega @ Vh[..., None, None, :, :]
        return torch.einsum("...ijkl,...kl->...ij", dR_dA, gR)


def symmetric_orthogonalization(A: torch.Tensor) -> torch.Tensor:
    """Closest orthogonal matrix R = U V^h to A [..., n, n]."""
    return _SymmetricOrthogonalization.apply(A)


def weighted_kabsch(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    use_epsilon_on_weights: bool = False):
    """T = [R|t] minimising sum_i w_i ||R x_i + t - y_i||^2. x, y [..., N, 3],
    w [..., N] (>= 0). Returns (T [..., 4, 4] fp32, not_enough_points [...]
    bool). With fewer than 3 weighted points EPSILON is added to every
    weight, the reference's fallback."""
    w = w.clamp(min=0.0)
    enough = (w > 0).sum(-1) >= 3
    if use_epsilon_on_weights:
        w = w + EPSILON
    else:
        w = torch.where(enough[..., None], w, w + EPSILON)
    cum = w.sum(-1)[..., None]
    mx = (x * w[..., None]).sum(-2) / cum
    my = (y * w[..., None]).sum(-2) / cum
    xc = x - mx[..., None, :]
    yc = y - my[..., None, :]
    sxy = torch.einsum("...ni,...nj->...ij", yc * w[..., None], xc) / cum[..., None]
    R = symmetric_orthogonalization(sxy)
    t = my - torch.einsum("...ij,...j->...i", R, mx)
    top = torch.cat([R, t[..., None]], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2), ~enough


def kabsch_from_flow(pts: torch.Tensor, flow: torch.Tensor, w: torch.Tensor,
                     **kw):
    """Rigid transform explaining per-point flow: aligns pts -> pts + flow."""
    return weighted_kabsch(pts, pts + flow, w, **kw)
