"""Entry `stream`: offline perception over recorded drives through the
port's serving path, `serve.encode` once and then `serve.fused_streaming`
(SLIM flow from the previous frame's cached features + CenterPoint on the
new frame), a closed loop over `streams` drives in lockstep.

A step starts with the batch's points in pinned host memory and ends with
flow, box positions and box logits copied back into pinned host buffers.
After the window, a sample of the window's steps drawn from the seed is
recomputed by the plain reference in fp32 (`portbench/reference`) from the
same frames and weights, and compared.
"""
from __future__ import annotations

import functools
import time
from contextlib import contextmanager

import numpy as np
import torch

from portbench import gen, yardstick
from portbench.harness import p95
from portbench.instrument import wrap_ops
from portbench.reference import models as ref
from portbench.weights import make_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Workload:
    def __init__(self, config, traffic, seed, device, tmpdir):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.trace_steps = int(traffic["trace_steps"])
        self.dtype = DTYPES[config["serve_dtype"]]
        self.precision = yardstick.precision_of(self.dtype)
        self.streams = int(traffic["streams"])
        self.n_frames = int(traffic["frames"])

    # -- set-up ---------------------------------------------------------
    def make_inputs(self):
        """The drives, in pinned host memory, and the weights: the
        benchmark's, handed alike to the program and to the reference."""
        c, t, dev = self.config, self.traffic, self.device
        bev = ref.bev_of(c)
        # the reference's layout names every weight; the benchmark makes
        # them from the seed and loads the same values into both sides
        with torch.device("meta"):
            self.slim_state = make_state(
                ref.RefSlim(bev, int(c["slim"]["num_iters"])), self.seed, dev,
                small_std=("heads_conv2",))
            self.det_state = make_state(ref.RefBoxLearner(bev),
                                        self.seed + 1, dev)
        t_in = time.perf_counter()
        n_obj = gen.objects_per_drive(*t["objects"], self.streams, self.seed)
        drives = [gen.make_drive(
            gen.stream_seed(self.seed, s), n_frames=self.n_frames,
            n_max=int(c["n_max"]), point_range=t["points"],
            n_objects=n_obj[s], speed_range_mps=t["speed_mps"],
            scene_seed=int(t["scene_seed"]) + s,
            ego_speed_mps=float(t["ego_speed_mps"]), hz=float(t["hz"]),
            device=dev) for s in range(self.streams)]
        pin = dev.type == "cuda"
        pts = torch.stack([d.points for d in drives], 1).cpu()
        valid = torch.stack([d.valid for d in drives], 1).cpu()
        self.points = pts.pin_memory() if pin else pts  # [T, B, N, 4]
        self.valid = valid.pin_memory() if pin else valid
        del drives
        self.input_phases = {"drives_s": round(time.perf_counter() - t_in, 3)}
        rng = np.random.RandomState(self.seed % (2**32))
        self.check_at = set(int(i) for i in rng.choice(
            int(t["check_from"]), size=int(t["check_steps"]), replace=False))

    def setup(self):
        from liso_tpu_torch import serve
        from liso_tpu_torch.models.box_learner import BoxLearner
        from liso_tpu_torch.models.slim import SlimModel
        from liso_tpu_torch.ops.bev import BevSetup

        t0 = time.perf_counter()
        self.make_inputs()
        t1 = time.perf_counter()
        c, t, dev = self.config, self.traffic, self.device
        self.serve = serve
        bev = ref.bev_of(c)
        pbev = BevSetup(bev.bev_range_m, bev.grid_size)
        self.slim = SlimModel(pbev, num_iters=int(c["slim"]["num_iters"]),
                              compute_dtype=self.dtype, device=dev).eval()
        self.det = BoxLearner(pbev, network="centerpoint",
                              use_baseline_parameters=True,
                              compute_dtype=self.dtype, device=dev).eval()
        self.slim.load_state_dict(self.slim_state)
        self.det.load_state_dict(self.det_state)
        pin = dev.type == "cuda"
        g = int(c["grid_size"])
        k = (g // 4) ** 2
        b = self.streams

        def buf(*shape):
            x = torch.empty(*shape)
            return x.pin_memory() if pin else x

        self.out = (buf(b, g, g, 2), buf(b, k, 3), buf(b, k, 1))
        self.samples = []
        self.window_step = -1  # warm-up steps are not in the window

        self.t = 0
        self.fmap, self.cn = self.serve.encode(
            self.slim, self._put(self.points[0]), self._put(self.valid[0]))
        self.t = 1
        t2 = time.perf_counter()
        for _ in range(int(t["warmup_steps"])):
            self.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.window_step = 0
        self.phases = {**self.input_phases, "inputs_s": round(t1 - t0, 3),
                       "program_s": round(t2 - t1, 3),
                       "warmup_s": round(time.perf_counter() - t2, 3)}

    def _put(self, x):
        return x.to(self.device, non_blocking=True)

    @functools.cached_property
    def flops_per_step(self) -> float:
        """Model operations of one streaming step, counted on the meta
        device: encode the new frame (pillar PFN, RAFT encoder), the flow
        iterations (update block and correlation lookups), CenterPoint."""
        c = self.config
        bev = ref.bev_of(c)
        b, n, g = self.streams, int(c["n_max"]), int(c["grid_size"])
        iters = int(c["slim"]["num_iters"])
        with torch.device("meta"):
            slim = ref.RefSlim(bev, iters)
            det = ref.RefBoxLearner(bev)
            pts = torch.zeros(b, n, 4)
            valid = torch.ones(b, n, dtype=torch.bool)
            with yardstick.count_flops(slim) as fs, \
                    yardstick.count_flops(det) as fd:
                fmap, cn = slim.encode(pts, valid)
                slim.raft.flow_from_features(fmap, cn, fmap,
                                             upsample_all=False)
                det(pts, valid)
        # the reference builds a whole-volume pyramid; the model's
        # operations are the lookups' windows
        coarse = fmap.shape[1] * fmap.shape[2]
        corr = iters * yardstick.corr_lookup_flops(
            b, coarse, int(c["slim"]["corr_feature_dim"]),
            int(c["slim"]["corr_levels"]), int(c["slim"]["corr_radius"]))
        return fs["flops"] + fd["flops"] + corr

    # -- the timed path ---------------------------------------------------
    def step(self):
        from torch.profiler import record_function

        t_prev, t = (self.t - 1) % self.n_frames, self.t
        with record_function("pb.h2d"):
            pts = self._put(self.points[t])
            valid = self._put(self.valid[t])
        with record_function("pb.stream_step"):
            fmap, cn, flow, pos, probs = self.serve.fused_streaming(
                self.slim, self.det, self.fmap, self.cn, pts, valid)
        with record_function("pb.d2h"):
            for dst, src in zip(self.out, (flow, pos, probs)):
                dst.copy_(src, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if self.window_step in self.check_at:
            self.samples.append((t_prev, t, *(o.clone() for o in self.out)))
        if self.window_step >= 0:
            self.window_step += 1
        self.fmap, self.cn = fmap, cn
        self.t = (t + 1) % self.n_frames
        return self.streams, {}

    def sampled_all(self) -> bool:
        """Whether every step that the check samples has run."""
        return len(self.samples) == len(self.check_at)

    @contextmanager
    def instrumented(self, record):
        with wrap_ops(record, ("K1", "K2")):
            yield

    def end_to_end(self, record) -> dict:
        return {
            "stream_frames_per_s": record.items / record.window_s,
            "stream_frame_ms_p95": p95(record.step_s) * 1e3,
        }

    # -- correctness ------------------------------------------------------
    def close_program(self):
        del self.slim, self.det, self.fmap, self.cn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, t_prev, t, fp8: bool = False):
        """The plain reference's (flow, pos, probs) of the step from frame
        t_prev to frame t, fp32 (or the fp8 control)."""
        c, dev = self.config, self.device
        if getattr(self, "_ref_kind", None) != fp8:
            bev = ref.bev_of(c)
            rs = ref.RefSlim(bev, int(c["slim"]["num_iters"]),
                             device=dev).eval()
            rd = ref.RefBoxLearner(bev, device=dev).eval()
            rs.load_state_dict(self.slim_state)
            rd.load_state_dict(self.det_state)
            if fp8:
                ref.to_fp8(rs)
                ref.to_fp8(rd)
            self._ref, self._ref_kind = (rs, rd), fp8
        rs, rd = self._ref
        with torch.inference_mode(), ref.precision("fp32"):
            p0, v0 = self._put(self.points[t_prev]), self._put(self.valid[t_prev])
            p1, v1 = self._put(self.points[t]), self._put(self.valid[t])
            flow = rs.flow(p0, v0, p1, v1)
            boxes, _, _ = rd(p1, v1)
            return flow.cpu(), boxes["pos"].cpu(), boxes["probs"].cpu()

    def control_numbers(self) -> dict:
        """The control's numbers: the reference with fp8 operands in the
        program's place against the reference in fp32, on the frame pairs
        that a run's sampled steps would have. Needs only `make_inputs`."""
        pairs = [((i + int(self.traffic["warmup_steps"])) % self.n_frames,
                  (i + 1 + int(self.traffic["warmup_steps"])) % self.n_frames)
                 for i in sorted(self.check_at)]
        ctrl = [self.reference_outputs(a, b, fp8=True) for a, b in pairs]
        self.samples = [(a, b, *o) for (a, b), o in zip(pairs, ctrl)]
        return {k: v["value"] for k, v in self.check()[1].items()}

    def check(self):
        """Each sampled step's outputs against the reference's: the widest
        gap of the flow (m), of the box centers (m) and of the box logits,
        over every cell and box of the batch."""
        gaps = {"flow_m": 0.0, "pos_m": 0.0, "logit": 0.0}
        for t_prev, t, flow, pos, probs in self.samples:
            rflow, rpos, rprobs = self.reference_outputs(t_prev, t)
            for key, a, b in (("flow_m", flow, rflow), ("pos_m", pos, rpos),
                              ("logit", probs, rprobs)):
                d = (a.float() - b.float()).abs().max().item()
                gaps[key] = max(gaps[key], d if np.isfinite(d) else np.inf)
        limits = self.traffic["limits"]
        checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
        checks["steps_checked"] = {"value": len(self.samples),
                                   "limit": int(self.traffic["check_steps"])}
        ok = (len(self.samples) == int(self.traffic["check_steps"])
              and all(gaps[k] <= limits[k] for k in gaps))
        return ok, checks
