"""Flow -> RGB visualisation (reference: liso/visu/flow_image.py).

Standard optical-flow color wheel: hue = flow direction, saturation/value =
magnitude (normalised per image). Pure numpy, feeds TB image summaries.
"""
from __future__ import annotations

import numpy as np


def flow_to_rgb(flow: np.ndarray, max_mag: float = None) -> np.ndarray:
    """[H, W, 2] -> uint8 [H, W, 3]."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx**2 + fy**2)
    ang = np.arctan2(fy, fx)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    h = (ang + np.pi) / (2 * np.pi)  # [0, 1)
    s = np.clip(mag / max_mag, 0, 1)
    v = np.ones_like(s)
    return (hsv_to_rgb(np.stack([h, s, v], -1)) * 255).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], -1)
