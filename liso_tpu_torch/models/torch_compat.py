"""Reference-checkpoint conversion: torch SLIM/RAFT state_dicts -> flax params.

Port of liso_tpu/models/torch_compat.py (the conversion is a copy). The
reference trains RAFT-small in torch (liso/slim/model/raft_mod.py:19-257)
and reloads checkpoints for flow export (liso/slim/cli.py:33-50). This module
converts such a state_dict into the parameter tree of
``models.raft.RAFT(joint_encoders=False, torch_compat=True)`` so a
reference-trained network reproduces its flow here (the only route to
trained-system parity in an environment without the real datasets).

Inputs are mappings of NUMPY arrays keyed by the reference's state_dict
names (load with ``torch.load(...)`` and pass ``{k: v.numpy() ...}``); the
conversion itself is numpy alone. ``load_reference_raft`` (below the
conversion) takes the state_dict as tensors or arrays and returns the
port's RAFT with the converted weights, on the card unless asked for the
CPU.

Layout bridges handled (see models/raft.py for the TPU-side design):

* torch OIHW conv kernels -> flax HWIO.
* ConvGRU convz+convr -> one fused ``convzr`` conv (output-concat).
* The twin flow/logits towers of SmallMotionEncoder (update.py:41-93) ->
  one tower over concatenated inputs with BLOCK-DIAGONAL kernels (exact:
  each output group reads only its own input channels).
* The two FlowOrClassificationHeads (update.py:96-128) -> one shared hidden
  conv (output-concat) + one grouped output conv (feature_group_count=2).
* Channel-order bridges: the reference keeps flow in RAFT (x, y) = (col,
  row) order internally (raft_mod.py:136-198) while this rebuild uses
  (row, col) -> flow input/output channels of the motion encoder and flow
  head swap; the reference's motion-feature concat is [out, cls, flow]
  (update.py:91) while the fused tower emits [out, flow, cls] -> GRU input
  channels permute.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np


def _conv(sd: Mapping[str, np.ndarray], pfx: str):
    out = {"kernel": np.transpose(np.asarray(sd[pfx + ".weight"]), (2, 3, 1, 0))}
    b = sd.get(pfx + ".bias")
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def _norm(sd: Mapping[str, np.ndarray], pfx: str):
    return {
        "scale": np.asarray(sd[pfx + ".weight"]),
        "bias": np.asarray(sd[pfx + ".bias"]),
    }


def _residual_block(sd, pfx: str, norm_fn: str):
    p = {"conv1": _conv(sd, pfx + ".conv1"), "conv2": _conv(sd, pfx + ".conv2")}
    with_norm = norm_fn != "none"
    if with_norm:
        p["norm1"] = _norm(sd, pfx + ".norm1")
        p["norm2"] = _norm(sd, pfx + ".norm2")
    if pfx + ".downsample.0.weight" in sd:
        p["down"] = _conv(sd, pfx + ".downsample.0")
        if with_norm:
            p["norm3"] = _norm(sd, pfx + ".norm3")
    return p


def convert_small_encoder(
    sd: Mapping[str, np.ndarray], pfx: str = "", norm_fn: str = "instance_affine"
):
    """Reference SmallEncoder (extractor.py:211) -> flax
    models.raft.SmallEncoder(torch_compat=True) params. ``pfx`` e.g.
    ``"fnet."`` when converting from a full RAFT state_dict."""
    p = {"conv1": _conv(sd, pfx + "conv1"), "conv2": _conv(sd, pfx + "conv2")}
    if norm_fn != "none":
        p["norm1"] = _norm(sd, pfx + "norm1")
    for i, stage in enumerate(("layer1", "layer2", "layer3"), 1):
        for j, sub in enumerate("ab"):
            p[f"layer{i}{sub}"] = _residual_block(
                sd, f"{pfx}{stage}.{j}", norm_fn
            )
    return p


def _block_diag_kernel(k_a: np.ndarray, k_b: np.ndarray) -> np.ndarray:
    """Two HWIO kernels -> one where outputs [0:oa] read inputs [0:ia] via
    k_a and outputs [oa:] read inputs [ia:] via k_b (zeros elsewhere)."""
    kh, kw, ia, oa = k_a.shape
    kh2, kw2, ib, ob = k_b.shape
    assert (kh, kw) == (kh2, kw2)
    k = np.zeros((kh, kw, ia + ib, oa + ob), k_a.dtype)
    k[:, :, :ia, :oa] = k_a
    k[:, :, ia:, oa:] = k_b
    return k


_XY_TO_RC = (1, 0)  # reference flow channels are (x=col, y=row); ours (row, col)


def convert_update_block(sd: Mapping[str, np.ndarray], pfx: str = "update_block."):
    """Reference SmallUpdateBlock (update.py:96, with predict_logits=True and
    predict_weight_for_static_aggregation enabled — the liso preset) ->
    params for models.raft.SmallUpdateBlock."""
    me = pfx + "motion_encoder."

    # --- motion encoder -----------------------------------------------------
    # conv_flow1 consumes (flow_x, flow_y, weight_logit); ours consumes
    # (flow_row, flow_col, weight_logit): swap the two flow input channels.
    kf1 = _conv(sd, me + "conv_flow1")
    kf1k = kf1["kernel"][:, :, (*_XY_TO_RC, 2), :]
    kc1 = _conv(sd, me + "conv_class1")
    flowcls1 = {
        "kernel": _block_diag_kernel(kf1k, kc1["kernel"]),
        "bias": np.concatenate([kf1["bias"], kc1["bias"]]),
    }
    kf2 = _conv(sd, me + "conv_flow2")
    kc2 = _conv(sd, me + "conv_class2")
    flowcls2 = {
        "kernel": _block_diag_kernel(kf2["kernel"], kc2["kernel"]),
        "bias": np.concatenate([kf2["bias"], kc2["bias"]]),
    }
    # the joint conv consumes [corr96, flow32, cls32] in both layouts
    # (update.py:87 concat order == ours after the tower fusion)
    motion = {
        "conv_stat_corr1": _conv(sd, me + "conv_stat_corr1"),
        "conv_flowcls1": flowcls1,
        "conv_flowcls2": flowcls2,
        "conv": _conv(sd, me + "conv"),
    }

    # --- GRU -----------------------------------------------------------------
    # reference motion features: [out80, cls32, flow32] (update.py:91);
    # ours: [out80, flow32, cls32]. GRU input hx = [h96, inp64, motion144]:
    # permute input channels 240:272 <-> 272:304 on every gate conv.
    perm = np.arange(96 + 64 + 144)
    perm[240:272] = np.arange(272, 304)
    perm[272:304] = np.arange(240, 272)

    def gate(name):
        c = _conv(sd, pfx + "gru." + name)
        return {"kernel": c["kernel"][:, :, perm, :], "bias": c["bias"]}

    z, r, q = gate("convz"), gate("convr"), gate("convq")
    gru = {
        "convzr": {
            "kernel": np.concatenate([z["kernel"], r["kernel"]], axis=-1),
            "bias": np.concatenate([z["bias"], r["bias"]]),
        },
        "convq": q,
    }

    # --- heads ---------------------------------------------------------------
    # heads_conv1 = [static_flow_head.conv1 (128) ++ classification_head.conv1
    # (128)] output-concat; heads_conv2 = grouped conv, group 1 = flow head
    # output conv (3 ch (row, col, weight) padded to 4), group 2 = cls head.
    fh1 = _conv(sd, pfx + "static_flow_head.conv1")
    ch1 = _conv(sd, pfx + "classification_head.conv1")
    heads_conv1 = {
        "kernel": np.concatenate([fh1["kernel"], ch1["kernel"]], axis=-1),
        "bias": np.concatenate([fh1["bias"], ch1["bias"]]),
    }
    fh2 = _conv(sd, pfx + "static_flow_head.conv2")
    ch2 = _conv(sd, pfx + "classification_head.conv2")
    kh, kw, cin, n_flow_out = fh2["kernel"].shape
    assert n_flow_out == 3, "liso preset predicts (flow2 + aggregation weight)"
    # output channel order: ref (x, y, w) -> ours (row, col, w); pad to 4
    fk = np.zeros((kh, kw, cin, 4), fh2["kernel"].dtype)
    fk[..., :3] = fh2["kernel"][..., (*_XY_TO_RC, 2)]
    fb = np.zeros((4,), fh2["bias"].dtype)
    fb[:3] = fh2["bias"][[*_XY_TO_RC, 2]]
    # flax grouped-conv kernel: [kh, kw, cin_per_group, out_total]
    heads_conv2 = {
        "kernel": np.concatenate([fk, ch2["kernel"]], axis=-1),
        "bias": np.concatenate([fb, ch2["bias"]]),
    }
    return {
        "motion_encoder": motion,
        "gru": gru,
        "heads_conv1": heads_conv1,
        "heads_conv2": heads_conv2,
    }


def convert_raft_state_dict(
    sd: Mapping[str, np.ndarray], fnet_norm: str = "instance_affine"
):
    """Full reference RAFT state_dict (fnet + cnet + update_block; the
    pp_layer pillar weights are converted separately by the caller if
    needed) -> params for RAFT(joint_encoders=False, torch_compat=True,
    predict_weight_for_static_aggregation=True)."""
    return {
        "fnet": convert_small_encoder(sd, "fnet.", fnet_norm),
        "cnet": convert_small_encoder(sd, "cnet.", "none"),
        "update_block": convert_update_block(sd, "update_block."),
    }


# ---------------------------------------------------------------------------
# The port's side: the converted weights in the port's RAFT
# ---------------------------------------------------------------------------
def load_reference_raft(state_dict, grid_size, *,
                        fnet_norm: str = "instance_affine", num_iters: int = 6,
                        resolution_m: float = 0.2, dtype=None, device=None):
    """The reference's RAFT state_dict (fnet + cnet + update_block, as
    tensors or numpy arrays; other keys such as the pillar layer's are
    ignored) in the port's ``RAFT(joint_encoders=False, torch_compat=True,
    predict_weight_for_static_aggregation=True)`` at `grid_size` (the BEV
    image's (H, W)), in eval mode, on `device` (the card unless
    ``device="cpu"``; without CUDA it raises). This is the reference's
    load path for flow export (liso/slim/cli.py:33-50). Raises if a
    converted leaf names no tensor of the network, if shapes differ, or if
    a tensor is left unfilled."""
    import torch

    from liso_tpu_torch.models.raft import RAFT
    from liso_tpu_torch.serve import resolve_device
    from liso_tpu_torch.weights import load_flax_variables

    dev = resolve_device(device)
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v))
          for k, v in state_dict.items()}
    params = convert_raft_state_dict(sd, fnet_norm)
    raft = RAFT(tuple(grid_size), in_channels=sd["fnet.conv1.weight"].shape[1],
                num_iters=num_iters, resolution_m=resolution_m,
                fnet_norm=fnet_norm, joint_encoders=False, torch_compat=True,
                predict_weight_for_static_aggregation=True, dtype=dtype,
                device=dev)
    return load_flax_variables(raft, {"params": params}).eval()


def _encoder_shapes(pfx: str, cin: int, out: int, norm_fn: str):
    """({conv name: OIHW shape}, {norm name: width}) of a reference
    SmallEncoder (extractor.py:211) under `pfx`."""
    convs = {pfx + "conv1": (32, cin, 7, 7), pfx + "conv2": (out, 96, 1, 1)}
    norms = {pfx + "norm1": 32}
    prev = 32
    for i, f in ((1, 32), (2, 64), (3, 96)):
        for j in (0, 1):
            blk = f"{pfx}layer{i}.{j}."
            convs[blk + "conv1"] = (f, prev, 3, 3)
            convs[blk + "conv2"] = (f, f, 3, 3)
            norms[blk + "norm1"] = norms[blk + "norm2"] = f
            if i > 1:  # the stride-2 block and the dummy_in_filters one
                convs[blk + "downsample.0"] = (f, prev, 1, 1)
                norms[blk + "norm3"] = f
            prev = f
    return convs, norms if norm_fn != "none" else {}


def random_reference_state_dict(seed: int, corr_channels: int, *,
                                in_channels: int = 64, hidden_dim: int = 96,
                                context_dim: int = 64,
                                fnet_norm: str = "instance_affine"):
    """A random state_dict in the reference RAFT's layout: every key that
    ``convert_raft_state_dict`` reads, as float32 numpy arrays drawn from
    `seed` (conv kernels N(0, 1/fan_in), biases 0.1 N, norm scales
    1 + 0.2 N and shifts 0.2 N). `corr_channels` is the motion encoder's
    corr input, `models.raft.corr_channels(grid_size)` (196 at 4 levels,
    radius 3). For the tests and the card check, where no reference
    checkpoint is at hand."""
    rng = np.random.RandomState(seed)
    convs, norms = {}, {}
    for pfx, out, norm in (("fnet.", 128, fnet_norm),
                           ("cnet.", hidden_dim + context_dim, "none")):
        c, n = _encoder_shapes(pfx, in_channels, out, norm)
        convs.update(c)
        norms.update(n)
    me, ub = "update_block.motion_encoder.", "update_block."
    gru_in = hidden_dim + context_dim + 144
    convs.update({
        me + "conv_stat_corr1": (96, corr_channels, 1, 1),
        me + "conv_flow1": (64, 3, 7, 7),
        me + "conv_class1": (64, 4, 7, 7),
        me + "conv_flow2": (32, 64, 3, 3),
        me + "conv_class2": (32, 64, 3, 3),
        me + "conv": (80, 96 + 64, 3, 3),
        ub + "gru.convz": (hidden_dim, gru_in, 3, 3),
        ub + "gru.convr": (hidden_dim, gru_in, 3, 3),
        ub + "gru.convq": (hidden_dim, gru_in, 3, 3),
        ub + "static_flow_head.conv1": (128, hidden_dim, 3, 3),
        ub + "static_flow_head.conv2": (3, 128, 3, 3),
        ub + "classification_head.conv1": (128, hidden_dim, 3, 3),
        ub + "classification_head.conv2": (4, 128, 3, 3),
    })
    sd = {}
    for name, shape in convs.items():
        fan_in = int(np.prod(shape[1:]))
        sd[name + ".weight"] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(
            np.float32)
        sd[name + ".bias"] = (0.1 * rng.randn(shape[0])).astype(np.float32)
    for name, width in norms.items():
        sd[name + ".weight"] = (1 + 0.2 * rng.randn(width)).astype(np.float32)
        sd[name + ".bias"] = (0.2 * rng.randn(width)).astype(np.float32)
    return sd
