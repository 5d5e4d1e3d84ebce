"""Weight bridge: liso_tpu (flax) variables -> the port's modules.

The port's modules carry the flax module names, so a flax path such as
params/raft/joint/layer1a/conv1/kernel names the torch submodule
`raft.joint.layer1a.conv1`. Leaves map as:
  * conv kernel [kh, kw, in/groups, out] (HWIO) -> weight [out, in/groups,
    kh, kw] (OIHW); grouped convs (feature_group_count) keep their groups;
  * ConvTranspose kernel [kh, kw, in, out] -> weight [in, out, kh, kw] with
    both spatial axes flipped (flax does not flip, torch's transposed conv
    does);
  * Dense kernel [in, out] -> weight [out, in];
  * DenseGeneral kernels of the attention (flax MultiHeadDotProductAttention)
    -> the weight of one Linear with the heads flattened head-major: the
    query / key / value kernel [d, heads, head_dim] and the output kernel
    [heads, head_dim, d] both read as [in_features, out_features] and are
    transposed; a [heads, head_dim] bias is flattened;
  * GroupNorm / BatchNorm / MaskedBatchNorm / LayerNorm scale, bias ->
    weight, bias;
  * batch_stats mean, var -> running_mean, running_var.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from liso_tpu_torch.models.slim import MovAvgState

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(sub: nn.Module, leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        if isinstance(sub, nn.ConvTranspose2d):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3 and isinstance(sub, nn.Linear):
            return "weight", arr.reshape(sub.in_features, -1).T
        raise ValueError(f"kernel of rank {arr.ndim}")
    if leaf == "scale":
        return "weight", arr
    if leaf == "bias":
        return "bias", arr.reshape(-1) if isinstance(sub, nn.Linear) else arr
    raise KeyError(leaf)


def flax_state_dict(module: nn.Module, variables: Mapping) -> dict:
    """The module's tensors named by a flax variables tree {"params": ...,
    "batch_stats": ...} of nested dicts of numpy arrays, converted to the
    module's layout: {state_dict key: torch.Tensor}. Raises if a flax leaf
    names no tensor of the module or if shapes differ. Also converts a tree
    shaped like the params (an optimizer moment) given as "params"."""
    state = module.state_dict()
    out = {}
    leaves = [
        (("params",) + p, v) for p, v in _flatten(variables.get("params", {}))
    ] + [
        (("batch_stats",) + p, v)
        for p, v in _flatten(variables.get("batch_stats", {}))
    ]
    for path, value in leaves:
        coll, mod_path, leaf = path[0], ".".join(path[1:-1]), path[-1]
        arr = np.asarray(value)
        try:
            sub = module.get_submodule(mod_path)
            if coll == "batch_stats":
                name = _STATS[leaf]
            else:
                name, arr = _convert(sub, leaf, arr)
        except (AttributeError, KeyError) as e:
            raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart") from e
        key = f"{mod_path}.{name}" if mod_path else name
        if key not in state:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such tensor")
        if tuple(state[key].shape) != arr.shape:
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {arr.shape} vs "
                f"{tuple(state[key].shape)}"
            )
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `module` (SlimModel or BoxLearner) from a flax variables tree
    {"params": ..., "batch_stats": ...} of nested dicts of numpy arrays.
    Raises if a flax leaf names no tensor of the module, if shapes differ,
    or if a tensor of the module is left unfilled."""
    tensors = flax_state_dict(module, variables)
    state = module.state_dict()
    missing = sorted(set(state) - set(tensors))
    if missing:
        raise KeyError(f"tensors without a flax leaf: {missing}")
    with torch.no_grad():
        for key, value in tensors.items():
            state[key].copy_(value)
    return module


def _load_moments(trainer, state: Mapping, names) -> None:
    """Copy the params-shaped optimizer moments `names` of a JAX state into
    the trainer's dicts of the same names."""
    for name in names:
        moment = flax_state_dict(trainer.model, {"params": state[name]})
        mine = getattr(trainer, name)
        if set(moment) != set(mine):
            raise KeyError(f"{name} leaves {sorted(set(moment) ^ set(mine))} differ")
        with torch.no_grad():
            for key, value in moment.items():
                mine[key].copy_(value)


def load_slim_train_state(trainer, state: Mapping):
    """Carry a JAX `SlimTrainState` across into a `SlimTrainer`, given as
    numpy: {"step", "params", "batch_stats", "nu", "movavg" ({field: array}
    of MovAvgState)} and, for a trainer with optimizer="adam", also "mu"
    and "count" (Adam's count, `ScaleByAdamState.count`). "nu" (and "mu")
    are params-shaped trees: RMSprop's second moment, or Adam's moments.
    The optimizer's schedule count must equal the step. The JAX state's
    class counters of the supervised threshold are not carried: the port
    trains without them."""
    load_flax_variables(trainer.model, {"params": state["params"],
                                        "batch_stats": state["batch_stats"]})
    adam = trainer.optimizer == "adam"
    _load_moments(trainer, state, ("mu", "nu") if adam else ("nu",))
    trainer.count = int(state["count"]) if adam else 0
    trainer.step = int(state["step"])
    trainer.movavg = MovAvgState(**{
        k: torch.as_tensor(np.array(v), dtype=torch.float32,
                           device=trainer.device)
        for k, v in state["movavg"].items() if k in MovAvgState._fields
    })
    return trainer


def load_detector_train_state(trainer, state: Mapping):
    """Carry a JAX `DetectorTrainState`, `PPTrainState` or `PRTrainState`
    across into the port's `DetectorTrainer`, `PointPillarsTrainer` or
    `PointRCNNTrainer` (the same fields on both sides), given as numpy: {"step", "params", "batch_stats", "mu", "nu" (the
    AdamW moments, params-shaped trees), "count" (the optimizer's count,
    which its schedule reads)}."""
    load_flax_variables(trainer.model, {"params": state["params"],
                                        "batch_stats": state["batch_stats"]})
    _load_moments(trainer, state, ("mu", "nu"))
    trainer.step = int(state["step"])
    trainer.count = int(state["count"])
    return trainer
