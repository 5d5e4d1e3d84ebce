"""Entry `slim_step`: SLIM scene-flow training's step body
(`train/slim_experiment.SlimExperiment.run`): the train loader's next batch
(`SlimExperiment.train_loader`, the Prefetcher over `data/dataset.py`) and
`SlimExperiment.train_batch` (the batch as a FlowSample, the trainer's
`train_step`, the step's metrics read back in one transfer).

Set-up writes a drive of the traffic mix as the port's `.npy` samples under
the run's temporary directory, builds the experiment from the
configuration's presets as `slim_cli` builds it, loads the weights that the
benchmark makes from the seed, and sets the train state's step to the end
of the warm-up (`train.first_step`), as a resumed run's state is. It then
drives the step body three times and keeps what the plain reference needs
to follow them: the loader's batches, the loss terms, step 1's gradient
(each leaf's `.grad`, which the step leaves in place) and last-iteration
flow, and the model, RMSprop's nu and the dynamicness threshold after step
3. The same objects go on into the window.
"""
from __future__ import annotations

import functools
import statistics
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from portbench import gen, slim_costs, yardstick
from portbench.entries.round_step import write_drive
from portbench.reference import compare
from portbench.reference import models as ref
from portbench.reference import slim_step as refstep
from portbench.weights import clone_state, make_state

CAPTURED_STEPS = 3
# the steps whose loss terms are compared: step 1 alone, from the same state
# and batch on both sides. From step 2 on, the last iteration's terms move
# with the first update's rounding (the 1-NN's masked and chosen points
# flip): the program read up to 1.9e-3 there, past the TF32 control's least
LOSS_STEPS = 1
BATCH_KEYS = ("pcl_t0", "valid_t0", "pcl_t1", "valid_t1", "odom_t0_t1",
              "odom_t1_t0")


def slim_cfg_of(config) -> refstep.SlimCfg:
    s, t = config["slim"], config["train"]
    return refstep.SlimCfg(
        bev=ref.bev_of(config), num_iters=int(s["num_iters"]),
        corr_levels=int(s["corr_levels"]), corr_radius=int(s["corr_radius"]),
        pillar_channels=int(s["pillar_channels"]),
        hidden_dim=int(s["hidden_dim"]), context_dim=int(s["context_dim"]),
        corr_feature_dim=int(s["corr_feature_dim"]),
        downsample=int(s["downsample"]),
        learning_rate=float(t["learning_rate"]),
        warmup_steps=int(t["warmup_steps"]),
        train_steps=int(t["train_steps"]))


def _batch_arrays(batch: dict) -> tuple:
    return tuple(np.array(batch[k].cpu() if torch.is_tensor(batch[k])
                          else batch[k]) for k in BATCH_KEYS)


class Workload:
    def __init__(self, config, traffic, seed, device, tmpdir):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.tmpdir = Path(tmpdir)
        self.trace_steps = int(traffic["trace_steps"])
        self.precision = "fp32"
        self.batch = int(config["train"]["batch_size"])
        self.cfg = slim_cfg_of(config)
        self.first_step = int(config["train"]["first_step"])

    # -- set-up ---------------------------------------------------------
    def _program_cfg(self):
        """The configuration tree as `slim_cli -c <presets>` parses it, with
        the grid, range and iterations this file states (equal to the
        presets' at the cell's size; a cut test cell states less)."""
        from liso_tpu_torch.cli.common import DEFAULT_CFG
        from liso_tpu_torch.utils.config import parse_config

        c = self.config
        cfg = parse_config(DEFAULT_CFG, list(c["presets"]))
        g, r = int(c["grid_size"]), float(c["bev_range_m"])
        cfg.data.img_grid_size = (g, g)
        cfg.data.bev_range_m = (r, r)
        cfg.SLIM.model.num_iters = int(c["slim"]["num_iters"])
        return cfg

    def make_inputs(self):
        """The drive's sample files and the weights: the benchmark's,
        handed alike to the program and to the reference."""
        c, t, dev = self.config, self.traffic, self.device
        self.n_max = int(c["n_max"])
        self.height_range = tuple(c["pillar_height_range_m"])
        drive = gen.make_drive(
            self.seed, n_frames=int(t["frames"]), n_max=self.n_max,
            point_range=t["points"], n_objects=int(t["objects"]),
            speed_range_mps=t["speed_mps"], scene_seed=int(t["scene_seed"]),
            ego_speed_mps=float(t["ego_speed_mps"]), hz=float(t["hz"]),
            ground_points=int(t["ground_points"]),
            crop_half_m=0.5 * float(c["bev_range_m"]), device=dev)
        self.data = self.tmpdir / "data"
        files = write_drive(self.data, drive, "drive")[0]
        del drive
        # the loader's index of each sample: its place among the sorted files
        self.files = sorted(files)
        with torch.device("meta"):
            self.state0 = make_state(refstep.RefSlimTrain(self.cfg), self.seed,
                                     dev, small_std=("heads_conv2",))

    def setup(self):
        from liso_tpu_torch.data.dataset import DataCfg
        from liso_tpu_torch.data.kitti import KittiRawDataset
        from liso_tpu_torch.ops.bev import BevSetup
        from liso_tpu_torch.train.slim_experiment import SlimExperiment

        t0 = time.perf_counter()
        self.make_inputs()
        t1 = time.perf_counter()
        cfg = self._program_cfg()
        bev = BevSetup(tuple(cfg.data.bev_range_m),
                       tuple(cfg.data.img_grid_size))
        # the train dataset as slim_cli's build_datasets makes it for KITTI
        dcfg = DataCfg(bev=bev, n_max=self.n_max, m_max=2 * self.n_max,
                       use_skip_frames=str(cfg.data.use_skip_frames),
                       flow_source=str(cfg.data.flow_source),
                       odom_source=str(cfg.data.odom_source))
        self.skip_mode = dcfg.use_skip_frames
        ds = KittiRawDataset(dcfg, self.data)
        self.ds_seed = int(ds.seed)
        exp = SlimExperiment(cfg, bev, ds, None, self.tmpdir / "log",
                             device=self.device)
        self._same_settings(cfg, exp.trainer, dcfg)
        tr = exp.trainer
        tr.model.load_state_dict(self.state0)
        tr.step = self.first_step
        self.exp = exp
        self.loader = exp.train_loader()
        self.it = iter(self.loader)

        t2 = time.perf_counter()
        self.captured = []
        flows = []
        hook = tr.model.register_forward_hook(
            lambda m, args, out: flows.append(
                (out[0][-1][..., 4:6].detach().cpu(),
                 out[1][-1][..., 4:6].detach().cpu())) if not flows else None)
        for i in range(CAPTURED_STEPS):
            self.step(capture=True)
            if i == 0:
                hook.remove()
                self.prog_flow = flows[0]
                self.prog_grad = {
                    k: (p.grad if p.grad is not None else torch.zeros_like(p))
                    .detach().clone() for k, p in tr.params.items()}
        self.prog_after = {**clone_state(tr.model.state_dict()),
                           **{f"nu.{k}": v.detach().clone()
                              for k, v in tr.nu.items()}}
        from liso_tpu_torch.models.slim import movavg_value

        self.prog_thr = float(movavg_value(tr.movavg))
        self.prog_importance = tr.movavg.importance.detach().clone()
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        self.phases = {"inputs_s": round(t1 - t0, 3),
                       "program_s": round(t2 - t1, 3),
                       "steps_s": round(time.perf_counter() - t2, 3)}

    def _same_settings(self, cfg, trainer, dcfg):
        """The program runs the configuration this file states; a preset
        that says otherwise stops the run before anything is measured."""
        c, s, t = self.config, self.config["slim"], self.config["train"]
        raft = trainer.model.raft
        lc = trainer.lcfg
        want = {
            "optimizer": (trainer.optimizer, t["optimizer"]),
            "batch_size": (int(cfg.SLIM.batch_size), self.batch),
            "num_workers": (int(cfg.data.num_workers), int(t["num_workers"])),
            "detect_anomaly": (trainer.detect_anomaly, bool(t["detect_anomaly"])),
            "grad_clip_norm": (float(trainer.grad_clip_norm), 0.0),
            "train_dtype": (trainer.model.compute_dtype, None),
            "lr": ([float(trainer.lr_schedule(i)) for i in
                    (0, self.first_step - 1, self.first_step, self.first_step + 2)],
                   [refstep.lr_at(self.cfg, i) for i in
                    (0, self.first_step - 1, self.first_step, self.first_step + 2)]),
            "grid": (tuple(trainer.bev.grid_size), (int(c["grid_size"]),) * 2),
            "range": (tuple(trainer.bev.bev_range_m),
                      (float(c["bev_range_m"]),) * 2),
            "num_iters": (raft.num_iters, self.cfg.num_iters),
            "corr": ((raft.corr_levels, raft.corr_radius, raft.downsample),
                     (self.cfg.corr_levels, self.cfg.corr_radius,
                      self.cfg.downsample)),
            "predict_weight_for_static_aggregation": (
                trainer.dcfg.predict_weight_for_static_aggregation,
                s["predict_weight_for_static_aggregation"]),
            "use_static_aggr_flow_for_aggr_flow": (
                lc.use_static_aggr_flow_for_aggr_flow,
                bool(s["use_static_aggr_flow_for_aggr_flow"])),
            "loss": ({k: float(getattr(lc, k)) for k in c["loss"]["factors"]},
                     {k: float(v) for k, v in c["loss"]["factors"].items()}),
            "knn_loss": ((lc.knn.fov_mode, lc.knn.L1_delta,
                          lc.knn.drop_outliers_perc, lc.knn.weight_slope),
                         (c["loss"]["fov_mode"], 0.0, 0.0, 0.0)),
            "use_skip_frames": (dcfg.use_skip_frames, t["use_skip_frames"]),
        }
        for key, (prog, mine) in want.items():
            if prog != mine:
                raise SystemExit(f"the program's {key} {prog} is not the "
                                 f"configuration's {mine}")

    @functools.cached_property
    def flops_per_step(self) -> float:
        """A train step's operations: three times the forward's convolution
        and linear operations in both directions (counted on the meta
        device) and its correlation lookups' windows."""
        c, n = self.config, self.n_max
        with torch.device("meta"):
            model = refstep.RefSlimTrain(self.cfg)
            pts = torch.zeros(self.batch, n, 4)
            valid = torch.ones(self.batch, n, dtype=torch.bool)
            with yardstick.count_flops(model) as f:
                model(pts, valid, pts, valid)
        from portbench.reference.raft import coarse_size

        hc = coarse_size(int(c["grid_size"]), self.cfg.downsample)
        corr = 2 * self.cfg.num_iters * yardstick.corr_lookup_flops(
            self.batch, hc * hc, self.cfg.corr_feature_dim,
            self.cfg.corr_levels, self.cfg.corr_radius)
        return 3.0 * (f["flops"] + corr)

    # -- the timed path ---------------------------------------------------
    def step(self, capture: bool = False):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("pb.wait"):
            try:
                batch = next(self.it)
            except StopIteration:
                self.it = iter(self.loader)
                batch = next(self.it)
        t1 = time.perf_counter()
        with record_function("pb.train_step"):
            metrics = self.exp.train_batch(batch)
        t2 = time.perf_counter()
        if capture:
            self.captured.append({
                "sample_id": list(batch["sample_id"]),
                "loaded": _batch_arrays(batch),
                "losses": metrics,
            })
        return self.batch, {"wait": t1 - t0, "step": t2 - t1}

    def sampled_all(self) -> bool:
        """Set-up runs every step that the check follows."""
        return True

    @contextmanager
    def instrumented(self, record):
        with slim_costs.recorded(record):
            yield

    def end_to_end(self, record) -> dict:
        # a sample: one t0 -> t1 pair, trained in both directions
        return {"det_train_samples_per_s": record.items / record.window_s}

    # -- correctness ------------------------------------------------------
    def close_program(self):
        self.it.close()
        self.loader.close()
        del self.exp, self.it, self.loader
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_run(self, kind: str = "fp32", corr_vjp: str = "autograd"):
        """The reference's batches, read from the files, and its three
        steps from the benchmark's weights, in `kind` ("fp32"; a control:
        "tf32", "bf16conv")."""
        index = {f.stem: i for i, f in enumerate(self.files)}
        batches = [refstep.read_flow_batch(
            [self.files[index[s]] for s in cap["sample_id"]],
            [index[s] for s in cap["sample_id"]], 0, self.ds_seed,
            self.skip_mode, self.n_max, (float(self.config["bev_range_m"]),) * 2,
            self.height_range) for cap in self.captured]
        out = refstep.train_steps(
            self.state0, [b[:4] for b in batches], self.cfg, self.first_step,
            len(self.files), self.device, kind, corr_vjp)
        out["loaded"] = batches
        return out

    def _ext(self, reference):
        """The state and gradient with RMSprop's nu as leaves "nu.<leaf>"
        (nu starts at 0; its leaves move with their parameter's
        gradient)."""
        state0 = {**self.state0, **{f"nu.{k}": torch.zeros_like(v)
                                    for k, v in reference["grad"].items()}}
        grad = {**reference["grad"],
                **{f"nu.{k}": v for k, v in reference["grad"].items()}}
        return state0, grad

    def numbers(self, prog, reference) -> dict:
        """The compared numbers of a side `prog` (the program's readings,
        or a control's) against the reference."""
        state0, grad = self._ext(reference)
        keys = compare.moved_leaves(grad, state0, reference["after"])
        upd = compare.leaf_gaps(compare.delta(prog["after"], state0, keys),
                                compare.delta(reference["after"], state0, keys))
        terms = list(reference["losses"][0])
        flow = max(float((a.float().cpu() - b.float().cpu()).abs().max())
                   for a, b in zip(prog["flow"], reference["flow"]))
        return {
            "data_gap": max(compare.batch_gap((p[0], p[1], dict(enumerate(p[2:]))),
                                              (r[0], r[1], dict(enumerate(r[2:]))))
                            for p, r in zip(prog["loaded"], reference["loaded"])),
            "loss_rel": compare.loss_rel(
                [{k: lp[k] for k in terms} for lp in prog["losses"][:LOSS_STEPS]],
                reference["losses"][:LOSS_STEPS]),
            "grad_gap": compare.leaf_gap(prog["grad"], reference["grad"])[0],
            # the median leaf's: the worst leaf's moves by fp32 rounding
            "update_gap": statistics.median(upd.values()),
            # the threshold after step 3 by the curve it is the least of:
            # the largest gap of the program's cumulative improvement from
            # the reference's, over the reference curve's range. The
            # threshold's own value jumps between near-equal minima of the
            # curve with rounding alone (PERF.md)
            "thr_gap": self.curve_gap(prog["importance"],
                                      reference["importance"]),
            "flow_m": flow if np.isfinite(flow) else float("inf"),
        }

    @staticmethod
    def curve_gap(prog_importance, ref_importance) -> float:
        cp = refstep.improvement_curve(prog_importance.cpu())
        cr = refstep.improvement_curve(ref_importance.cpu())
        gap = float((cp - cr).abs().max() / (cr.max() - cr.min()).clamp(min=1e-30))
        return gap if np.isfinite(gap) else float("inf")

    def details(self, prog, reference) -> dict:
        """Where the training numbers come from: each step's worst loss
        term, and the worst leaves of the gradient and of the change."""
        state0, grad = self._ext(reference)
        keys = compare.moved_leaves(grad, state0, reference["after"])
        upd = compare.leaf_gaps(compare.delta(prog["after"], state0, keys),
                                compare.delta(reference["after"], state0, keys))
        grads = compare.leaf_gaps(prog["grad"], reference["grad"])
        terms = list(reference["losses"][0])
        return {
            "loss_by_step": compare.loss_rel_by_step(
                [{k: lp[k] for k in terms} for lp in prog["losses"]],
                reference["losses"]),
            "grad_leaf": max(grads, key=grads.get),
            "grad_gap_median": statistics.median(grads.values()),
            "update_leaf": max(upd, key=upd.get),
            "update_gap_worst": max(upd.values()),
            "leaves_compared": len(keys),
            "thr": [prog["thr"], reference["thr"]],
            "loss": [[lp["loss"] for lp in prog["losses"]],
                     [lr["loss"] for lr in reference["losses"]]],
        }

    def control_numbers(self, kind: str = "tf32") -> dict:
        """A control's numbers: the reference in `kind` in the program's
        place ("tf32", "bf16conv", or "k5": the correlation's backward
        rounded as the port's kernel rounds it), on batches of a seeded
        sample order, against the reference in fp32. Needs only
        `make_inputs`."""
        rng = np.random.RandomState(self.seed % (2**31) + 1)
        order = [self.files[i].stem for i in rng.permutation(len(self.files))]
        self.captured = [{"sample_id": order[i * self.batch:(i + 1) * self.batch]}
                         for i in range(CAPTURED_STEPS)]
        self.ds_seed, self.skip_mode = 0, self.config["train"]["use_skip_frames"]
        reference = self.reference_run("fp32")
        side = (self.reference_run("fp32", corr_vjp="k5") if kind == "k5"
                else self.reference_run(kind))
        return {**self.numbers(side, reference),
                "details": self.details(side, reference)}

    def program_side(self) -> dict:
        """The program's readings of the captured steps, as `numbers`
        takes a side."""
        return {"loaded": [c["loaded"] for c in self.captured],
                "losses": [c["losses"] for c in self.captured],
                "grad": self.prog_grad, "after": self.prog_after,
                "thr": self.prog_thr, "importance": self.prog_importance,
                "flow": self.prog_flow}

    def check(self):
        reference = self.reference_run("fp32")
        prog = self.program_side()
        nums = self.numbers(prog, reference)
        self.last_details = self.details(prog, reference)
        limits = self.traffic["limits"]
        checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
        return all(nums[k] <= limits[k] for k in nums), checks
