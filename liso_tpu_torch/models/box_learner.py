"""BoxLearner facade: detector network + activation + decode (port of
liso_tpu/models/box_learner.py for the centerpoint and transfusion
networks; PointPillars and PointRCNN have their own pipelines). flax's
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
from liso_tpu_torch.models.transfusion import TransFusionNet
from liso_tpu_torch.ops.bev import BevSetup


class BoxLearner(nn.Module):
    def __init__(self, bev: BevSetup, box_cfg: BoxPredictionCfg = BoxPredictionCfg(),
                 network: str = "centerpoint", hid_dim: int = 64,
                 use_baseline_parameters: bool = True, point_features: int = 4,
                 compute_dtype=None, num_decoder_layers: int = 1, device=None):
        super().__init__()
        self.bev = bev
        self.box_cfg = box_cfg
        self.network = network
        kw = dict(head_channels=box_cfg.head_channels(), hid_dim=hid_dim,
                  point_features=point_features, dtype=compute_dtype,
                  device=device)
        if network == "centerpoint":
            self.model = CenterPointNet(
                bev, use_baseline_parameters=use_baseline_parameters, **kw)
        elif network == "transfusion":
            self.model = TransFusionNet(
                bev, num_decoder_layers=num_decoder_layers, **kw)
        else:
            raise NotImplementedError(f"network {network!r}")

    def _require_centerpoint(self):
        # only the centerpoint path consumes a shared pillar prep or image;
        # failing loudly beats re-encoding the cloud
        if self.network != "centerpoint":
            raise NotImplementedError(
                "point_feats_only/pillar_image require network='centerpoint'"
                f", got {self.network!r}")

    def point_feats(self, points, valid, prepared=None):
        """Pre-scatter per-point PFN features (x [B, N, C], prepared) for the
        fused scatter (pillar_encoder.fused_scatter_images)."""
        self._require_centerpoint()
        return self.model.pfn.point_feats(points, valid, prepared=prepared)

    def forward(self, points, valid, prepared=None, pillar_image=None):
        """-> (flat Boxes, decoded maps, activated maps, aux). TransFusion's
        aux also holds the dense heatmap logits (`heatmap`), every decoder
        layer's raw maps (`layer_maps`) and the peaks' scores
        (`query_heatmap_score`)."""
        aux = {}
        if self.network == "transfusion":
            if pillar_image is not None:
                self._require_centerpoint()
            raw_maps, occ, tf_aux = self.model(points, valid)
            aux["heatmap"] = tf_aux["dense_heatmap"]
            aux["layer_maps"] = tf_aux["layer_maps"]
            aux["query_heatmap_score"] = tf_aux["query_heatmap_score"]
        else:
            raw_maps, occ = self.model(points, valid, prepared, pillar_image)
        aux["occupancy"] = occ
        activated = apply_activations(raw_maps, self.box_cfg)
        decoded = decode_box_maps(activated, self.box_cfg, self.bev)
        return flatten_to_boxes(decoded), decoded, activated, aux
