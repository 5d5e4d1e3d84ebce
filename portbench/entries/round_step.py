"""Entry `round_step`: the rounds loop's step body
(`train/liso_loop.LisoSelfTraining.run`): the train loader's next batch
(`data/pipeline.Prefetcher` over `data/dataset.py`), `_prepare_batch`
(the host copy-paste and the pinned copy to the card), the detector's
`train_step`, and the loss read back.

Set-up writes a drive of the traffic mix as the port's `.npy` samples
under the run's temporary directory, with a mined-box DB and an
augmentation DB made from the drive's planted objects, and loads those as
a resume loads them. The benchmark makes the detector's weights from the
seed. Set-up then drives the step body three times and keeps what the
plain reference needs to follow them: the loader's batches, the pasted
batches, the loss terms, AdamW's first moment after step 1 (the gradient
as the optimizer got it) and the state after step 3. The same object goes
on into the window.
"""
from __future__ import annotations

import functools
import statistics
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from portbench import gen, yardstick
from portbench.instrument import wrap_ops
from portbench.reference import compare
from portbench.reference import detector_step as refstep
from portbench.reference import models as ref
from portbench.reference.augmentation import BoxAugmCfg
from portbench.reference.box_decode import BoxPredictionCfg
from portbench.weights import clone_state, make_state

CAPTURED_STEPS = 3
LOSS_STEPS = 2  # the steps whose loss terms are compared


def box_cfg_of(config) -> BoxPredictionCfg:
    bp = dict(config["box_prediction"])
    return BoxPredictionCfg(**bp)


def write_drive(root: Path, drive: gen.Drive, stem: str) -> tuple:
    """Samples (t0, t1, t2 = frames i, i+1, i+2) as the ETL writes them,
    a mined-box DB of the planted objects at t0 inside the crop, and an
    augmentation DB of one snippet per object. Returns (sample files,
    mined DB, augm DB path, mined DB path)."""
    samples = root / "kitti_raw"
    samples.mkdir(parents=True)
    pts = gen.to_numpy(drive.points)
    keep = gen.to_numpy(drive.valid | drive.ground)
    ground = gen.to_numpy(drive.ground)
    ego = gen.to_numpy(drive.ego_x).astype(np.float64)
    centers = gen.to_numpy(drive.obj_centers)
    dims = gen.to_numpy(drive.obj_dims)
    yaw = gen.to_numpy(drive.obj_yaw)
    speed = gen.to_numpy(drive.obj_speed)
    n_samples = pts.shape[0] - 2
    files, mined = [], {}

    def pose(dx):
        m = np.eye(4)
        m[0, 3] = dx
        return m

    for i in range(n_samples):
        name = f"{stem}_{i:06d}"
        content = {"name": name}
        for j, tk in enumerate(("t0", "t1", "t2")):
            content[f"pcl_{tk}"] = pts[i + j][keep[i + j]]
            content[f"is_ground_{tk}"] = ground[i + j][keep[i + j]]
        for tk, j in (("t1", 1), ("t2", 2)):
            content[f"odom_t0_{tk}"] = pose(ego[i + j] - ego[i])
            content[f"kiss_odom_t0_{tk}"] = pose(ego[i + j] - ego[i])
        f = samples / f"{name}.npy"
        np.save(f, content, allow_pickle=True)
        files.append(f)
        c = centers[i]
        inside = np.all(np.abs(c[:, :2]) < 49.0, axis=-1)
        k = int(inside.sum())
        lidar_T_box = np.tile(np.eye(4), (k, 1, 1))
        cy, sy = np.cos(yaw[inside]), np.sin(yaw[inside])
        lidar_T_box[:, 0, 0], lidar_T_box[:, 0, 1] = cy, -sy
        lidar_T_box[:, 1, 0], lidar_T_box[:, 1, 1] = sy, cy
        lidar_T_box[:, :3, 3] = c[inside]
        mined[name] = {
            "lidar_T_box": lidar_T_box,
            "raw_box": {
                "pos": c[inside].astype(np.float32),
                "dims": dims[inside].astype(np.float32),
                "rot": yaw[inside, None].astype(np.float32),
                "probs": np.full((k, 1), 0.9, np.float32),
                "velo": speed[inside, None].astype(np.float32),
            },
            "track_id": np.nonzero(inside)[0].astype(np.int64),
        }
    db_dir = root / "mined_round_1"
    db_dir.mkdir()
    np.savez_compressed(db_dir / "tracked", mined)
    local = gen.to_numpy(drive.obj_local)
    n_pts = gen.to_numpy(drive.obj_points)
    rows_rng = np.random.RandomState(int(drive.counts[0]))
    kk = len(dims)
    sensor_T_box = np.tile(np.eye(4), (kk, 1, 1))
    sensor_T_box[:, 0, 0], sensor_T_box[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    sensor_T_box[:, 1, 0], sensor_T_box[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    sensor_T_box[:, :3, 3] = centers[0]
    augm = {
        "pcl_in_box_cosy": [local[o, :n_pts[o]].astype(np.float32)
                            for o in range(kk)],
        "lidar_rows": [rows_rng.randint(0, 64, n_pts[o]) for o in range(kk)],
        "boxes": {
            "pos": centers[0].astype(np.float32),
            "dims": dims.astype(np.float32),
            "rot": yaw[:, None].astype(np.float32),
            "probs": np.full((kk, 1), 0.9, np.float32),
            "velo": speed[:, None].astype(np.float32),
        },
        "box_T_sensor": np.linalg.inv(sensor_T_box),
        "unique_track_id": np.arange(kk, dtype=np.int64),
    }
    np.save(db_dir / "augm_db.npy", augm, allow_pickle=True)
    return files, mined, db_dir / "augm_db.npy", db_dir / "tracked.npz"


def boxes_to_numpy(boxes) -> dict:
    return {k: getattr(boxes, k).detach().cpu().numpy()
            for k in refstep.BOX_KEYS + ("valid",)}


class Workload:
    def __init__(self, config, traffic, seed, device, tmpdir):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.tmpdir = Path(tmpdir)
        self.trace_steps = int(traffic["trace_steps"])
        self.precision = "fp32"
        self.batch = int(config["train"]["batch_size"])

    # -- set-up ---------------------------------------------------------
    def _program_cfg(self):
        import liso_tpu_torch
        from liso_tpu_torch.utils.config import parse_config

        yml = Path(liso_tpu_torch.__file__).parent / "config" / "liso_config.yml"
        cfg = parse_config(yml, list(self.config["presets"])
                           + list(self.traffic.get("extra_presets", [])))
        if int(cfg.seed) != int(self.config["seed"]):
            raise SystemExit(f"the program's seed {cfg.seed} is not the "
                             f"configuration's {self.config['seed']}")
        return cfg

    def make_inputs(self):
        """The drive's files, the DBs and the weights: the benchmark's,
        handed alike to the program and to the reference."""
        c, t, dev = self.config, self.traffic, self.device
        bev = ref.bev_of(c)
        self.bev = bev
        self.box_cfg = box_cfg_of(c)
        self.augm_cfg = BoxAugmCfg(**c["train"]["box_augm"])
        self.paste_on = bool(t["paste"])
        self.n_max = int(c["n_max"])
        self.k_max = int(c["train"]["k_max_boxes"])
        self.height_range = tuple(c["pillar_height_range_m"])

        drive = gen.make_drive(
            self.seed, n_frames=int(t["frames"]), n_max=self.n_max,
            point_range=t["points"], n_objects=int(t["objects"]),
            speed_range_mps=t["speed_mps"], scene_seed=int(t["scene_seed"]),
            ego_speed_mps=float(t["ego_speed_mps"]), hz=float(t["hz"]),
            ground_points=int(t["ground_points"]), device=dev)
        data = self.tmpdir / "data"
        self.files, self.mined, augm_path, mined_path = write_drive(
            data, drive, "drive")
        del drive
        self.augm_db = np.load(augm_path, allow_pickle=True).item()
        self.paths = (data, augm_path, mined_path)
        with torch.device("meta"):
            self.state0 = make_state(ref.RefBoxLearner(bev, self.box_cfg),
                                     self.seed, dev)

    def setup(self):
        from liso_tpu_torch.data.dataset import DataCfg
        from liso_tpu_torch.data.kitti import KittiRawDataset
        from liso_tpu_torch.ops.bev import BevSetup
        from liso_tpu_torch.tracker.dbs import load_augm_db, load_mined_boxes_db
        from liso_tpu_torch.train.liso_loop import (
            LisoSelfTraining,
            box_prediction_cfg,
        )

        t0 = time.perf_counter()
        self.make_inputs()
        t1 = time.perf_counter()
        t, dev, bev = self.traffic, self.device, self.bev
        data, augm_path, mined_path = self.paths
        cfg = self._program_cfg()
        pbev = BevSetup(bev.bev_range_m, bev.grid_size)
        dcfg = DataCfg(bev=pbev, n_max=self.n_max, m_max=2 * self.n_max,
                       k_max_boxes=self.k_max,
                       use_skip_frames=str(cfg.data.use_skip_frames),
                       flow_source=str(cfg.data.flow_source),
                       odom_source=str(cfg.data.odom_source))
        root = data

        def factory(mined_db):
            return KittiRawDataset(dcfg, root, mined_boxes_db=mined_db)

        loop = LisoSelfTraining(cfg, factory, None, self.tmpdir / "log",
                                data_cfg=dcfg, device=dev)
        self._same_settings(cfg, loop, box_prediction_cfg(cfg))
        loop.mined_db = load_mined_boxes_db(mined_path)
        loop._augm_db_final = load_augm_db(augm_path)
        loop.trainer.model.load_state_dict(self.state0)
        loop.trainer.reset_optimizer()
        loop.state = loop.trainer
        loop.round_idx = 1
        self.loop = loop
        self.loader = loop._train_loader(factory(loop.mined_db))
        self.it = iter(self.loader)

        t2 = time.perf_counter()
        self.captured = []
        for i in range(CAPTURED_STEPS):
            self.step(capture=True)
            if i == 0:
                self.prog_grad = {k: m.detach().clone() / (1 - refstep.ADAM_B1)
                                  for k, m in loop.trainer.mu.items()}
        self.prog_after = clone_state(loop.trainer.model.state_dict())
        for _ in range(int(t["warmup_steps"])):
            self.step()
        self.phases = {"inputs_s": round(t1 - t0, 3),
                       "program_s": round(t2 - t1, 3),
                       "steps_s": round(time.perf_counter() - t2, 3)}

    def _same_settings(self, cfg, loop, box_cfg):
        """The program runs the configuration this file states; a preset
        that says otherwise stops the run before anything is measured."""
        c = self.config["train"]
        tr = loop.trainer
        want = {
            "box_prediction": (box_cfg, self.box_cfg),
            "paste": (bool(cfg.data.augmentation.boxes.active), self.paste_on),
            "box_augm": (loop.box_augm_cfg._asdict(), self.augm_cfg._asdict()),
            "batch_size": (int(cfg.data.batch_size), self.batch),
            "num_workers": (int(cfg.data.num_workers), int(c["num_workers"])),
            "weight_decay": (float(tr.weight_decay), float(c["weight_decay"])),
            "lr": ([float(tr.lr_schedule(i)) for i in range(3)],
                   [refstep.onecycle(float(c["learning_rate"]),
                                     int(c["schedule_steps"]), i)
                    for i in range(3)]),
        }
        for key, (prog, mine) in want.items():
            if prog != mine:
                raise SystemExit(f"the program's {key} {prog} is not the "
                                 f"configuration's {mine}")

    @functools.cached_property
    def flops_per_step(self) -> float:
        """A train step's operations: three times the forward's convolution
        and linear operations, counted on the meta device."""
        with torch.device("meta"):
            det = ref.RefBoxLearner(self.bev, self.box_cfg)
            pts = torch.zeros(self.batch, self.n_max, 4)
            valid = torch.ones(self.batch, self.n_max, dtype=torch.bool)
            with yardstick.count_flops(det) as f:
                det(pts, valid)
        return 3.0 * f["flops"]

    # -- the timed path ---------------------------------------------------
    def step(self, capture: bool = False):
        from torch.profiler import record_function

        loop = self.loop
        t0 = time.perf_counter()
        with record_function("pb.wait"):
            try:
                batch = next(self.it)
            except StopIteration:
                self.it = iter(self.loader)
                batch = next(self.it)
        t1 = time.perf_counter()
        with record_function("pb.prepare"):
            pts, valid, target = loop._prepare_batch(batch)
        t2 = time.perf_counter()
        with record_function("pb.train_step"):
            metrics = loop.state.train_step(pts, valid, target)
        with record_function("pb.readback"):
            loss = float(metrics["loss/total"])
        t3 = time.perf_counter()
        if capture:
            self.captured.append({
                "sample_id": list(batch["sample_id"]),
                "loaded": (np.array(batch["pcl_t0"]), np.array(batch["valid_t0"]),
                           {k: np.array(v) for k, v in batch["target_boxes"].items()}),
                "pasted": (pts.cpu().numpy(), valid.cpu().numpy(),
                           boxes_to_numpy(target)),
                "losses": {k.split("/", 1)[1]: float(v) for k, v in metrics.items()
                           if k.startswith("loss/")},
            })
        del loss
        return self.batch, {"wait": t1 - t0, "prepare": t2 - t1,
                            "step": t3 - t2}

    def sampled_all(self) -> bool:
        """Set-up runs every step that the check follows."""
        return True

    @contextmanager
    def instrumented(self, record):
        with wrap_ops(record, ("K1", "K1_vjp")):
            yield

    def end_to_end(self, record) -> dict:
        return {"det_train_samples_per_s": record.items / record.window_s}

    # -- correctness ------------------------------------------------------
    def close_program(self):
        self.it.close()
        self.loader.close()
        del self.loop, self.it, self.loader
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_run(self, kind: str = "fp32"):
        """The reference's batches (read, then pasted), and its three steps
        from the benchmark's weights, in `kind` ("fp32", or "tf32" for the
        control)."""
        by_name = {f.stem: f for f in self.files}
        # the paste draws from the loop's generator, seeded by the
        # configuration's seed as the program seeds it
        rng = np.random.RandomState(int(self.config["seed"]))
        loaded, pasted = [], []
        for cap in self.captured:
            b = refstep.load_batch([by_name[s] for s in cap["sample_id"]],
                                   self.mined, self.n_max, self.k_max,
                                   self.bev.bev_range_m, self.height_range)
            loaded.append(b)
            pasted.append(refstep.paste(*b, self.augm_db, rng,
                                        self.bev.bev_range_m, self.augm_cfg)
                          if self.paste_on else b)
        c = self.config["train"]
        losses, grad, after = refstep.train_steps(
            self.state0, pasted, self.bev, self.box_cfg,
            float(c["learning_rate"]), int(c["schedule_steps"]),
            float(c["weight_decay"]), self.device, kind)
        return loaded, pasted, losses, grad, after

    def details(self, prog, reference) -> dict:
        """Where the training numbers come from: each step's worst loss
        term, and the worst leaves of the gradient and of the change."""
        loaded, pasted, losses, grad, after = reference
        keys = compare.moved_leaves(grad, self.state0, after)
        upd = compare.leaf_gaps(compare.delta(prog["after"], self.state0, keys),
                                compare.delta(after, self.state0, keys))
        grads = compare.leaf_gaps(prog["grad"], grad)
        return {
            "loss_by_step": compare.loss_rel_by_step(prog["losses"], losses),
            "grad_leaf": max(grads, key=grads.get),
            "grad_gap_median": statistics.median(grads.values()),
            "update_leaf": max(upd, key=upd.get),
            "update_gap_worst": max(upd.values()),
            "leaves_compared": len(keys),
        }

    def numbers(self, prog, reference) -> dict:
        """The compared numbers of a side `prog` (the program's readings,
        or the control's) against the reference."""
        loaded, pasted, losses, grad, after = reference
        keys = compare.moved_leaves(grad, self.state0, after)
        upd = compare.leaf_gaps(compare.delta(prog["after"], self.state0, keys),
                                compare.delta(after, self.state0, keys))
        return {
            "data_gap": max(compare.batch_gap(p, r)
                            for p, r in zip(prog["loaded"], loaded)),
            "paste_gap": max(compare.batch_gap(p, r)
                             for p, r in zip(prog["pasted"], pasted)),
            # steps 1-2: step 3's loss moves by fp32 rounding alone
            # (PERF.md: the reference against itself reads as much)
            "loss_rel": compare.loss_rel(prog["losses"][:LOSS_STEPS],
                                         losses[:LOSS_STEPS]),
            "grad_gap": compare.leaf_gap(prog["grad"], grad)[0],
            # the median leaf's: the worst leaf's moves by fp32 rounding
            "update_gap": statistics.median(upd.values()),
        }

    def control_numbers(self, kind: str = "tf32") -> dict:
        """The control's numbers: the reference in `kind` in the program's
        place, on batches of a seeded sample order, against the reference
        in fp32. Needs only `make_inputs`."""
        rng = np.random.RandomState(self.seed % (2**31) + 1)
        order = [f.stem for f in np.array(self.files)[rng.permutation(len(self.files))]]
        self.captured = [{"sample_id": order[i * self.batch:(i + 1) * self.batch]}
                         for i in range(CAPTURED_STEPS)]
        reference = self.reference_run("fp32")
        loaded, pasted, losses, grad, after = self.reference_run(kind)
        side = {"loaded": loaded, "pasted": pasted, "losses": losses,
                "grad": grad, "after": after}
        return {**self.numbers(side, reference),
                "details": self.details(side, reference)}

    def check(self):
        reference = self.reference_run("fp32")
        prog = {"loaded": [c["loaded"] for c in self.captured],
                "pasted": [c["pasted"] for c in self.captured],
                "losses": [c["losses"] for c in self.captured],
                "grad": self.prog_grad, "after": self.prog_after}
        nums = self.numbers(prog, reference)
        self.last_details = self.details(prog, reference)
        limits = self.traffic["limits"]
        checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
        return all(nums[k] <= limits[k] for k in nums), checks
