"""BoxLearner facade: detector network + activation + decode (port of
liso_tpu/models/box_learner.py for network="centerpoint"). flax's
`train=True` is `BoxLearner.train()` here: batch-norm statistics of the
batch, running statistics updated (models/centerpoint.py)."""
from __future__ import annotations

from torch import nn

from liso_tpu_torch.models.box_decode import (
    BoxPredictionCfg,
    apply_activations,
    decode_box_maps,
    flatten_to_boxes,
)
from liso_tpu_torch.models.centerpoint import CenterPointNet
from liso_tpu_torch.ops.bev import BevSetup


class BoxLearner(nn.Module):
    def __init__(self, bev: BevSetup, box_cfg: BoxPredictionCfg = BoxPredictionCfg(),
                 network: str = "centerpoint", hid_dim: int = 64,
                 use_baseline_parameters: bool = True, point_features: int = 4,
                 compute_dtype=None, device=None):
        super().__init__()
        if network != "centerpoint":
            raise NotImplementedError(f"network {network!r} is not ported yet")
        self.bev = bev
        self.box_cfg = box_cfg
        self.model = CenterPointNet(
            bev,
            head_channels=box_cfg.head_channels(),
            hid_dim=hid_dim,
            use_baseline_parameters=use_baseline_parameters,
            point_features=point_features,
            dtype=compute_dtype,
            device=device,
        )

    def point_feats(self, points, valid, prepared=None):
        """Pre-scatter per-point PFN features (x [B, N, C], prepared) for the
        fused scatter (pillar_encoder.fused_scatter_images)."""
        return self.model.pfn.point_feats(points, valid, prepared=prepared)

    def forward(self, points, valid, prepared=None, pillar_image=None,
                plain: bool = False):
        """-> (flat Boxes, decoded maps, activated maps, aux)."""
        raw_maps, occ = self.model(points, valid, prepared, pillar_image, plain)
        activated = apply_activations(raw_maps, self.box_cfg)
        decoded = decode_box_maps(activated, self.box_cfg, self.bev)
        return flatten_to_boxes(decoded), decoded, activated, {"occupancy": occ}
