"""Random weights made from the seed, on the device that serves them.

The benchmark makes every weight itself and hands the same values to the
program and to the reference, so neither takes anything the other made.
The scheme is the port's `init_weights`: convolution and linear kernels
~ N(0, 1/fan_in) (N(0, 1e-2) for the modules named in `small_std`),
biases 0, norm scales 1 and shifts 0, batch-norm statistics (0, 1). All
kernels come from ONE `torch.randn` call on a generator of the device.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def make_state(module: nn.Module, seed: int, device,
               small_std=()) -> dict:
    """A state_dict for `module` (parameter and buffer names as it has
    them): see the module docstring. Returned tensors are fp32 on
    `device`."""
    dev = torch.device(device)
    kernels = []  # (state key, shape, std)
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            leaf = name.split(".")[-1]
            std = 1e-2 if leaf in small_std else 1.0 / math.sqrt(fan_in)
            kernels.append((f"{name}.weight", tuple(w.shape), std))
    total = sum(math.prod(s) for _, s, _ in kernels)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63 - 1))
    flat = torch.randn(total, generator=gen, device=dev)
    state = {}
    off = 0
    for key, shape, std in kernels:
        n = math.prod(shape)
        state[key] = flat[off:off + n].view(shape) * std
        off += n
    for key, t in module.state_dict().items():
        if key in state:
            continue
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("running_var", "weight"):
            state[key] = torch.ones(t.shape, device=dev)
        else:  # biases, shifts, running means
            state[key] = torch.zeros(t.shape, device=dev)
    return state


def clone_state(state: dict, device=None) -> dict:
    return {k: v.detach().clone().to(device or v.device)
            for k, v in state.items()}
