"""Plain reference: a frozen copy of liso_tpu_torch/models/box_decode.py, boxes as a dict.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

Box decoding: raw attribute maps -> metric boxes (port of
liso_tpu/models/box_decode.py). Maps are channels-last [B, h, w, C].
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.bev import BevSetup

ACTIVATIONS: Dict[str, Callable] = {
    "none": lambda x: x,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
}


class BoxPredictionCfg(NamedTuple):
    """Box prediction config (liso_config.yml box_prediction with the
    centerpoint preset: local_relative_offset position with tanh, absolute
    size, rotation vector)."""

    position_method: str = "local_relative_offset"
    num_box_pos_dims: int = 3
    box_z_pos_prior_min: float = -1.5
    box_z_pos_prior_max: float = -0.5
    dimensions_method: str = "predict_abs_size"
    box_len_prior_min: float = 2.0
    box_len_prior_max: float = 8.0
    rotation_method: str = "vector"
    norm_vector_len: bool = False
    activations: Dict[str, str] = None  # type: ignore[assignment]

    def act(self, name: str) -> Callable:
        acts = self.activations or {
            "pos": "tanh",
            "dims": "softplus",
            "rot": "none",
            "probs": "none",
        }
        return ACTIVATIONS[acts.get(name, "none")]

    def head_channels(self):
        """(attr, channels) per head."""
        rot = {"direct": 1, "vector": 2, "none": 0, "class_bins": 36}[
            self.rotation_method
        ]
        dims = {
            "predict_aspect_ratio": 2,
            "predict_abs_size": 3,
            "predict_log_size": 3,
        }[self.dimensions_method]
        return (
            ("pos", self.num_box_pos_dims),
            ("dims", dims),
            ("rot", rot),
            ("probs", 1),
        )


def prediction_grid_centers(bev: BevSetup, grid_hw) -> np.ndarray:
    """[h, w, 2] metric centers of the (downsampled) prediction grid."""
    h, w = grid_hw
    res = (bev.bev_range_m[0] / h, bev.bev_range_m[1] / w)
    ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1) + 0.5
    return (ij * np.array(res) + np.array(bev.extent_min)).astype(np.float32)


def apply_activations(raw_maps: Dict[str, torch.Tensor], cfg: BoxPredictionCfg):
    return {k: cfg.act(k)(v) for k, v in raw_maps.items()}


def decode_box_maps(activated: Dict[str, torch.Tensor], cfg: BoxPredictionCfg,
                    bev: BevSetup) -> Dict[str, torch.Tensor]:
    out = dict(activated)

    dims = out["dims"]
    if cfg.dimensions_method == "predict_aspect_ratio":
        scale, aspect_inv = dims[..., 0:1], dims[..., 1:2]
        box_len = cfg.box_len_prior_min + scale * (
            cfg.box_len_prior_max - cfg.box_len_prior_min
        )
        out["dims"] = torch.cat([box_len, box_len * aspect_inv], dim=-1)
    elif cfg.dimensions_method == "predict_log_size":
        out["dims"] = torch.exp(dims)
    elif cfg.dimensions_method != "predict_abs_size":
        raise ValueError(cfg.dimensions_method)

    rot = out["rot"]
    if cfg.rotation_method == "vector":
        if cfg.norm_vector_len:
            rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp(min=1e-6)
        out["rot"] = torch.atan2(rot[..., 0:1], rot[..., 1:2])
    elif cfg.rotation_method == "class_bins":
        bin_size = 2 * math.pi / rot.shape[-1]
        out["rot"] = torch.argmax(rot, dim=-1, keepdim=True).float() * bin_size
    elif cfg.rotation_method != "direct":
        raise ValueError(cfg.rotation_method)

    pos = out["pos"]
    if cfg.position_method == "global_relative":
        bev_dims = torch.tensor(
            list(bev.bev_range_m) + [1.0] * (pos.shape[-1] - 2),
            dtype=torch.float32, device=pos.device,
        )
        out["pos"] = pos * bev_dims * 0.6
    elif cfg.position_method == "local_relative_offset":
        h, w = pos.shape[1:3]
        centers = torch.from_numpy(prediction_grid_centers(bev, (h, w))).to(
            pos.device
        )
        res = torch.tensor(
            [bev.bev_range_m[0] / h, bev.bev_range_m[1] / w],
            dtype=torch.float32, device=pos.device,
        )
        xy = centers[None] + res * 0.5 * pos[..., :2]
        if cfg.num_box_pos_dims == 3:
            z = cfg.box_z_pos_prior_min + 0.5 * (pos[..., 2:3] + 1.0) * (
                cfg.box_z_pos_prior_max - cfg.box_z_pos_prior_min
            )
            xy = torch.cat([xy, z], dim=-1)
        out["pos"] = xy
    elif cfg.position_method != "global_absolute":
        raise ValueError(cfg.position_method)
    return out


def flatten_to_boxes(decoded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """[B, h, w, C] maps -> {attr: [B, h*w, C]} (anchor-per-cell layout)."""
    b, h, w = decoded["pos"].shape[:3]
    return {k: v.reshape(b, h * w, v.shape[-1]) for k, v in decoded.items()}
