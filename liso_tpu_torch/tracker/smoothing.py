"""Track smoothing by Adam on the jerk (port of liso_tpu/tracker/smoothing.py).

Behavioral reference: liso/tracker/track_smoothing.py:38-290 (BatchedSmoothTrack
/ smooth_track_jerk) and :300-741 (the kinematic bicycle model). The loss
of the jerk smoothing is

  loss = mean(|diff^3 pos|) + 3.0 * mean(|pos - observed|^2)

with the first position frozen. Adam has optax.adam's semantics (eps
outside the root, bias corrections in fp32). Afterwards the yaw is turned
to the smoothed travel direction with growing frame skips until the
displacement reaches 1 m, and velo is the per-frame displacement.

The JAX package compiles the whole loop into one `fori_loop`. Here an
iteration is about 60 small launches; on the card the loop captures one
iteration (forward, gradient, Adam update) as a CUDA graph and replays it,
which launches the same kernels in the same order as the eager loop, so
the result is bitwise that of the eager loop.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from liso_tpu_torch.train.slim_train import ADAM_B1, ADAM_B2, ADAM_EPS

MIN_TRACK_LEN_FOR_SMOOTHING = 4
# warm-up iterations (on a copy of the state) before a CUDA graph capture
GRAPH_WARMUP = 2


def adam_minimize(loss_fn: Callable[..., torch.Tensor],
                  params0: List[torch.Tensor], iters: int, lr: float,
                  graph: bool = False) -> List[torch.Tensor]:
    """`iters` optax.adam(lr) steps on `loss_fn(*params)` from params0.
    graph=True (CUDA tensors only) replays one captured iteration."""
    params = [p.detach().clone().requires_grad_(True) for p in params0]
    if iters == 0:
        return [p.detach() for p in params]
    dev = params[0].device
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    # the bias corrections of every step, in fp32 as optax takes them; a
    # device counter picks the step's pair, so a replayed graph reads
    # its own step's
    count = torch.arange(1, iters + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32, device=dev) ** count
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32, device=dev) ** count
    it = torch.zeros(1, dtype=torch.long, device=dev)

    def step():
        grads = torch.autograd.grad(loss_fn(*params), params)
        b1 = torch.index_select(bc1, 0, it)
        b2 = torch.index_select(bc2, 0, it)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g.square())
                p.add_(-lr * ((m / b1) / (torch.sqrt(v / b2) + ADAM_EPS)))
            it.add_(1)

    if not graph:
        for _ in range(iters):
            step()
        return [p.detach() for p in params]

    if dev.type != "cuda":
        raise ValueError("a CUDA graph needs CUDA tensors")
    saved = [p.detach().clone() for p in params]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(min(GRAPH_WARMUP, iters)):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.no_grad():  # the warm-up moved the state: start again
        for p, s, m, v in zip(params, saved, mu, nu):
            p.copy_(s)
            m.zero_()
            v.zero_()
        it.zero_()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    for _ in range(iters):
        g.replay()
    return [p.detach() for p in params]


def _jerk_magnitude(pos: torch.Tensor) -> torch.Tensor:
    """[B, T, 3] -> [B, T] (third-difference norm, zero-padded)."""
    jerk = torch.linalg.norm(torch.diff(pos, n=3, dim=1), dim=-1)
    return torch.nn.functional.pad(jerk, (0, pos.shape[1] - jerk.shape[1]))


def _displacement(pos: torch.Tensor, num_skip: int = 1) -> torch.Tensor:
    """[B, T, 3] -> [B, T] displacement over num_skip frames, edge-padded
    (track_smoothing.batched_displacement_from_pos)."""
    disp = torch.linalg.norm(pos[:, num_skip:] - pos[:, :-num_skip], dim=-1)
    if num_skip == 1:
        return torch.cat([disp, disp[:, -1:]], dim=1)
    lo = num_skip // 2
    hi = num_skip - lo
    return torch.cat([disp[:, :lo], disp, disp[:, -hi:]], dim=1)


def _masked_mean(x, mask):
    return torch.where(mask, x, 0.0).sum(-1) / mask.sum(-1).clamp(min=1)


def smooth_track_jerk(
    observed_pos: torch.Tensor,  # [B, T, 3]
    valid: torch.Tensor,  # [B, T]
    observed_yaw: torch.Tensor,  # [B, T, 1]
    max_iters: int = 2000,
    learning_rate: float = 0.1,
    pos_regul_weight: float = 3.0,
    graph: bool | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (smoothed pos [B, T, 3], aligned yaw [B, T, 1], velo
    [B, T, 1]). graph (default: on CUDA tensors) replays a captured
    iteration."""
    b, t, _ = observed_pos.shape
    if t <= MIN_TRACK_LEN_FOR_SMOOTHING:
        return observed_pos, observed_yaw, _displacement(observed_pos)[..., None]
    if graph is None:
        graph = observed_pos.is_cuda

    def loss_fn(free_pos):
        pos = torch.cat([observed_pos[:, :1], free_pos], dim=1)
        jerk = _masked_mean(_jerk_magnitude(pos), valid)
        shift = ((pos - observed_pos) ** 2).sum(-1)
        regul = pos_regul_weight * _masked_mean(shift, valid)
        return (jerk + regul).mean()

    (free,) = adam_minimize(loss_fn, [observed_pos[:, 1:, :]], max_iters,
                            learning_rate, graph)
    pos = torch.cat([observed_pos[:, :1], free], dim=1)

    # yaw along the travel direction, the frame skip growing until the
    # displacement reaches 1 m (track_smoothing.py:222-266)
    min_disp = 1.0
    yaw = observed_yaw[..., 0]
    aligned = ~valid
    for skip in range(1, min(10, t // 2) + 1):
        far = _displacement(pos, num_skip=skip) >= min_disp
        delta = pos[:, skip:] - pos[:, :-skip]
        ang = torch.atan2(delta[..., 1], delta[..., 0])
        lo = skip // 2
        hi = skip - lo
        ang = torch.cat([ang[:, :lo] * 0 + ang[:, :1], ang,
                         ang[:, -1:].repeat_interleave(hi, 1)], dim=1)
        can = (~aligned) & far
        yaw = torch.where(can, ang, yaw)
        aligned = aligned | can
    # the rotation is constant at the track's start; the last valid frame
    # takes the one before it
    yaw = yaw.clone()
    yaw[:, 0] = yaw[:, 1]
    last = (valid.sum(-1) - 1).clamp(min=1)
    prev_of_last = (last - 1).clamp(min=0)
    bidx = torch.arange(b, device=yaw.device)
    yaw[bidx, last] = yaw[bidx, prev_of_last]
    return pos, yaw[..., None], _displacement(pos)[..., None]


# ---------------------------------------------------------------------------
# Kinematic bicycle-model smoothing (track_smoothing.py:300-741)
# ---------------------------------------------------------------------------
def _cauchy(x):
    return 0.5 + torch.atan(x) / math.pi


def _soft_sigmoid_clamp(x, a_min, a_max):
    """track_smoothing.soft_sigmoid_clamp: a smooth clamp by the Cauchy CDF
    of x / 100."""
    return a_min + (a_max - a_min) * _cauchy(x / 100.0)


def _orientations_along_track(pos, num_skip: int = 2):
    """Heading from skip-frame direction vectors, edge-padded
    (track_smoothing.get_orientations_along_track)."""
    d = pos[:, num_skip:, :2] - pos[:, :-num_skip, :2]
    ang = torch.atan2(d[..., 1], d[..., 0])
    lo = num_skip // 2
    hi = num_skip - lo
    return torch.cat([ang[:, :1].repeat_interleave(lo, 1), ang,
                      ang[:, -1:].repeat_interleave(hi, 1)], dim=1)


def _bike_rollout(initial_state, accel, steer, dt, vehicle_length,
                  max_yaw_rate, max_velocity):
    """The car dynamics over T (track_smoothing.py:300-338). State: [x, y,
    heading, velo, yaw_rate]; the velocity is soft-clamped to [0, max]."""
    states = [initial_state]
    state = initial_state
    for i in range(accel.shape[1] - 1):
        a, dd = accel[:, i], steer[:, i]
        x, y, h, v, hdot = (state[..., k] for k in range(5))
        new_hdot = _soft_sigmoid_clamp(hdot + dd * dt, -max_yaw_rate,
                                       max_yaw_rate)
        new_h = h + dt * torch.abs(v) / vehicle_length * new_hdot
        new_v = _soft_sigmoid_clamp(v + a * dt, 0.0, max_velocity)
        new_x = x + new_v * torch.cos(new_h) * dt
        new_y = y + new_v * torch.sin(new_h) * dt
        state = torch.stack([new_x, new_y, new_h, new_v, new_hdot], -1)
        states.append(state)
    return torch.stack(states, dim=1)  # [B, T, 5]


def smooth_track_bike_model(
    observed_pos: torch.Tensor,  # [B, T, 3]
    valid: torch.Tensor,  # [B, T]
    observed_yaw: torch.Tensor,  # [B, T, 1]
    vehicle_length: torch.Tensor,  # [B]
    time_between_frames_s: float = 0.1,
    max_iters: int = 1000,
    learning_rate: float = 0.1,
    accel_penalty_weight: float = 0.1,
    velo_penalty_weight: float = 0.1,
    pos_regul_weight: float = 1.0,
    max_velocity: float = 50.0,
    max_yaw_rate: float = math.pi / 2,
    graph: bool | None = None,
):
    """Kinematic-bicycle-model trajectory fit by Adam
    (track_smoothing.smooth_track_bike_model:577-741): controls warm-started
    at the clamp pre-images of the observed kinematics; loss = accel and
    steering L2, the yaw rate's L2 above its max, position MSE, all masked
    per-track means. Returns (pos [B, T, 3] with the observed z, yaw
    [B, T, 1], velo [B, T, 1]). graph (default: on CUDA tensors) replays a
    captured iteration."""
    b, t, _ = observed_pos.shape
    if t < MIN_TRACK_LEN_FOR_SMOOTHING:
        return observed_pos, observed_yaw, _displacement(observed_pos)[..., None]
    if graph is None:
        graph = observed_pos.is_cuda
    dt = time_between_frames_s
    init_yaw = _orientations_along_track(observed_pos)
    velo_init = torch.linalg.norm(
        observed_pos[:, 2:, :2] - observed_pos[:, :-2, :2], dim=-1) / (2 * dt)
    velo_init = torch.cat([velo_init[:, :1], velo_init, velo_init[:, -1:]], 1)
    yaw_step = torch.remainder(init_yaw[:, 1:] - init_yaw[:, :-1] + math.pi,
                               2 * math.pi) - math.pi
    hdot_obs = torch.cat([yaw_step, yaw_step[:, -1:]], dim=1) / dt

    def _pre_image(v, a_min, a_max):
        frac = ((v - a_min) / (a_max - a_min)).clamp(0.02, 0.98)
        return 100.0 * torch.tan(math.pi * (frac - 0.5))

    accel0 = (_pre_image(velo_init, 0.0, max_velocity)[:, 1:]
              - velo_init[:, :-1]) / dt
    steer0 = (_pre_image(hdot_obs, -max_yaw_rate, max_yaw_rate)[:, 1:]
              - hdot_obs[:, :-1]) / dt
    pad1 = lambda a: torch.cat([a, a[:, -1:]], dim=1)
    params0 = [pad1(accel0), pad1(steer0), observed_pos[:, 0, :2],
               init_yaw[:, :1], velo_init[:, :1], hdot_obs[:, :1]]

    def rollout(accel, steer, pos0, yaw0, velo0, hdot0):
        init = torch.cat([pos0, yaw0, velo0, hdot0], dim=-1)
        return _bike_rollout(init, accel, steer, dt, vehicle_length,
                             max_yaw_rate, max_velocity)

    def loss_fn(accel, steer, pos0, yaw0, velo0, hdot0):
        states = rollout(accel, steer, pos0, yaw0, velo0, hdot0)
        lin_pen = accel_penalty_weight * _masked_mean(accel ** 2, valid)
        yaw_pen = accel_penalty_weight * _masked_mean(steer ** 2, valid)
        hdot = states[..., 4]
        rate_pen = velo_penalty_weight * _masked_mean(
            torch.where(torch.abs(hdot) > max_yaw_rate, hdot ** 2, 0.0), valid)
        shift = ((states[..., :2] - observed_pos[..., :2]) ** 2).sum(-1)
        regul = pos_regul_weight * _masked_mean(shift, valid)
        return (lin_pen + yaw_pen + rate_pen + regul).mean()

    params = adam_minimize(loss_fn, params0, max_iters, learning_rate, graph)
    states = rollout(*params)
    pos = torch.cat([states[..., :2], observed_pos[..., 2:]], dim=-1)
    return pos, states[..., 2:3], _displacement(pos)[..., None]
