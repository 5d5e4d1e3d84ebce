"""SLIM experiment: training loop, flow eval, and flow export (port of
liso_tpu/train/slim_experiment.py).

Behavioral reference: liso/slim/experiment.py:71-919 (Experiment) and
:225-471 (run_inference_only). The exported npz schema is the JAX
package's, key for key — per sample: bev_raw_flow_{a}_{b} for all 6
ordered pairs of (t0, t1, t2), bev_dynamicness_{a}_{b}, static_threshold,
bev_range_m — so either package's detector stage can consume either's flow
exports. Export jobs shard by sample_idx % world_size == worker_id.

The trainer holds the train state (`SlimTrainer.state_dict()`), built with
the model; `run` restores the latest checkpoint of the log dir when it
first starts, where the JAX experiment restores once its state is first
built from a batch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from liso_tpu_torch.data.dataset import LidarDataset
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.eval.flow_metrics import FlowMetrics
from liso_tpu_torch.losses.slim_loss import SlimLossCfg
from liso_tpu_torch.models.slim import movavg_value
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids
from liso_tpu_torch.ops.scatter import scatter_mean_grid
from liso_tpu_torch.train.slim_train import SlimTrainer
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.atomic import publish
from liso_tpu_torch.utils.checkpoint import (
    check_checkpoint_config_sanity,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from liso_tpu_torch.utils.config import to_plain
from liso_tpu_torch.utils.tb import TBFactory

# the 3 unordered pairs over (t0, t1, t2); each exports fw + bw
# (experiment.py:386-456)
EXPORT_PAIRS = (("t0", "t1"), ("t0", "t2"), ("t1", "t2"))


def compute_moving_mask(
    pts: np.ndarray,
    flow_gt: np.ndarray,
    odom_t1_t0: np.ndarray,
    thresh: float,
) -> np.ndarray:
    """Point is moving iff its GT flow deviates from the full rigid ego
    flow R @ p + t - p by more than `thresh` (reference
    liso/eval/eval_ours.py:340-358). The translation term is essential:
    without it any ego motion (~1 m/frame) marks every point moving."""
    rigid_flow = pts @ odom_t1_t0[:3, :3].T + odom_t1_t0[:3, 3] - pts
    return np.linalg.norm(flow_gt - rigid_flow, axis=-1) > thresh


def batch_to_flow_sample(b: dict, device) -> FlowSample:
    """A collated batch (numpy, or tensors from a Prefetcher with a device)
    as a FlowSample on `device`; the odometry in fp32, cast on the device
    (jnp.asarray's float32 with x64 off)."""
    def t(x):
        return torch.as_tensor(x).to(device)

    return FlowSample(
        pcl_t0=PointCloud(t(b["pcl_t0"]), t(b["valid_t0"])),
        pcl_t1=PointCloud(t(b["pcl_t1"]), t(b["valid_t1"])),
        odom_t0_t1=t(b["odom_t0_t1"]).float(),
        odom_t1_t0=t(b["odom_t1_t0"]).float(),
    )


def slim_trainer_from_cfg(cfg, bev: BevSetup, num_train_samples: int,
                          device=None) -> SlimTrainer:
    """The experiment's SlimTrainer from the config tree, as the JAX
    function builds it: fp32 (no compute_dtype), seeded by SLIM.seed, with
    the SLIM preset's anomaly toggle as the trainer's non-finite check."""
    sl = cfg.SLIM
    lu = sl.losses.unsupervised
    loss_cfg = SlimLossCfg(
        knn_loss_penalty_factor=float(lu.knn_loss_penalty_factor),
        static_flow_penalty_factor=float(lu.static_flow_penalty_factor),
        fw_bw_static_trafo_penalty_factor=float(
            lu.fw_bw_static_trafo_penalty_factor
        ),
        knn_on_dynamic_penalty=float(lu.knn_on_dynamic_penalty),
        knn_on_static_penalty=float(lu.knn_on_static_penalty),
        artificial_cross_entropy_penalty=float(
            lu.artificial_labels.cross_entropy_penalty
        ),
        artificial_use_static_aggr_flow=bool(
            lu.artificial_labels.use_static_aggr_flow
        ),
        knn=SlimLossCfg().knn._replace(
            L1_delta=float(lu.knn_loss.L1_delta),
            drop_outliers_perc=float(lu.knn_loss.drop_outliers__perc),
            fov_mode=str(lu.knn_loss.fov_mode),
        ),
    )
    pw = sl.model.predict_weight_for_static_aggregation
    return SlimTrainer(
        bev,
        num_iters=int(sl.model.num_iters),
        predict_weight_for_static_aggregation=(
            pw if pw not in (False, "off", None) else False
        ),
        use_static_aggr_flow_for_aggr_flow=bool(
            sl.model.use_static_aggr_flow_for_aggr_flow
        ),
        loss_cfg=loss_cfg,
        optimizer=str(sl.optimizer),
        initial_lr=float(sl.learning_rate.initial),
        warmup_steps=int(sl.learning_rate.warm_up.step_length),
        train_steps=int(sl.iterations.train),
        num_train_samples=num_train_samples,
        seed=int(sl.seed),
        detect_anomaly=bool(getattr(sl, "set_detect_anomaly", False)),
        device=device,
    )


def _savez_compressed(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """np.savez_compressed through a file object, which keeps `path` as
    given (to a path not ending in .npz it would add the suffix)."""
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def export_sample(trainer: SlimTrainer, dataset: LidarDataset,
                  idx: int) -> Dict[str, np.ndarray]:
    """One sample's flow export: for each of the 6 ordered pairs the
    final-iteration aggregated flow (xy) and dynamicness, averaged per BEV
    cell, plus the static threshold and the BEV range."""
    bev = trainer.bev
    h, w = bev.grid_size
    dev = trainer.device
    arrays = {"bev_range_m": np.asarray(bev.bev_range_m)}
    for a, b in EXPORT_PAIRS:
        try:
            sp = dataset.get_pair(idx, a, b)
        except KeyError:
            continue  # sample lacks this time key
        fs = FlowSample(
            pcl_t0=PointCloud(torch.from_numpy(sp.frame_t0.pcl)[None].to(dev),
                              torch.from_numpy(sp.frame_t0.valid)[None].to(dev)),
            pcl_t1=PointCloud(torch.from_numpy(sp.frame_t1.pcl)[None].to(dev),
                              torch.from_numpy(sp.frame_t1.valid)[None].to(dev)),
            odom_t0_t1=torch.from_numpy(sp.odom_t0_t1)[None].to(dev).float(),
            odom_t1_t0=torch.from_numpy(sp.odom_t1_t0)[None].to(dev).float(),
        )
        pred_fw, pred_bw = trainer.predict_step(fs)
        for name, pred, pc in ((f"{a}_{b}", pred_fw, fs.pcl_t0),
                               (f"{b}_{a}", pred_bw, fs.pcl_t1)):
            cell, _, _ = point_cell_ids(pc.pcl[0, :, :2], bev, pc.valid[0])
            flow_grid, _ = scatter_mean_grid(
                pred.aggregated_flow[0][:, :2], cell, bev.num_cells)
            dyn_grid, _ = scatter_mean_grid(
                pred.dynamicness[0][:, None], cell, bev.num_cells)
            arrays[f"bev_raw_flow_{name}"] = (
                flow_grid.reshape(h, w, 2).cpu().numpy())
            arrays[f"bev_dynamicness_{name}"] = (
                dyn_grid.reshape(h, w).cpu().numpy())
    arrays["static_threshold"] = movavg_value(trainer.movavg).cpu().numpy()
    return arrays


class SlimExperiment:
    def __init__(self, cfg, bev: BevSetup, train_dataset: LidarDataset,
                 val_dataset: Optional[LidarDataset], log_dir, device=None):
        import yaml

        self.cfg = cfg
        self.bev = bev
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.log_dir = Path(log_dir)
        self.tb = TBFactory(self.log_dir / "tb")
        self.tb("train").add_text(
            "config", "```\n" + yaml.safe_dump(to_plain(cfg)) + "\n```", 0
        )
        self.trainer = slim_trainer_from_cfg(cfg, bev, len(train_dataset),
                                             device=device)
        self._started = False

    def maybe_restore(self, ckpt_path=None):
        """Load the latest checkpoint of `ckpt_path` (default: the log
        dir's ckpts/) into the trainer, if there is one."""
        ckpt_dir = Path(ckpt_path) if ckpt_path else self.log_dir / "ckpts"
        step = latest_step(ckpt_dir)
        if step is None:
            return
        # fail fast on incompatible checkpoints instead of an opaque
        # shape mismatch (reference load_checkpoint_check_sanity)
        check_checkpoint_config_sanity(
            ckpt_dir, self.cfg,
            keys=("data.img_grid_size", "data.bev_range_m"),
        )
        restore_checkpoint(ckpt_dir, step, self.trainer)

    # ------------------------------------------------------------------
    def train_loader(self) -> Prefetcher:
        """The training loader `run` iterates: the Prefetcher over the
        train dataset at the SLIM batch size, with the configured workers,
        its batches copied to the trainer's device."""
        return Prefetcher(
            self.train_dataset,
            batch_size=int(self.cfg.SLIM.batch_size),
            num_workers=int(self.cfg.data.num_workers) or 1,
            device=self.trainer.device,
        )

    def train_batch(self, batch: dict) -> Dict[str, float]:
        """One training step on a batch of `train_loader`: the batch as a
        FlowSample, `SlimTrainer.train_step`, and the step's metrics read
        back to the host in one transfer."""
        metrics = self.trainer.train_step(
            batch_to_flow_sample(batch, self.trainer.device))
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def run(self, max_steps: Optional[int] = None) -> SlimTrainer:
        """Train `max_steps` steps (default SLIM.iterations.train) through
        the Prefetcher; evaluate and save as the config says, and save at
        the end. As in the JAX loop, the local step counts from 0 on every
        call, also after a restore (it names the checkpoints)."""
        sl = self.cfg.SLIM
        total = max_steps or int(sl.iterations.train)
        eval_every = int(sl.iterations.eval_every)
        save_every = int(self.cfg.checkpoint.save_model_every)
        if not self._started:
            self.maybe_restore()
            self._started = True
        loader = self.train_loader()
        step = 0
        it = iter(loader)
        try:
            while step < total:
                with trace.span("slim.step", step=step) as step_span:
                    with trace.span("slim.wait") as wait:
                        try:
                            batch = next(it)
                        except StopIteration:
                            it = iter(loader)
                            batch = next(it)
                    metrics = self.train_batch(batch)
                # the loader's wait, and the rest of the step to its
                # metrics on the host
                wait_s = wait.seconds
                self.tb.global_step = step
                w = self.tb("train", "metrics/")
                w.add_scalars(metrics, step)
                w.add_scalar("timing/step_s", step_span.seconds - wait_s, step)
                w.add_scalar("timing/data_wait_s", wait_s, step)
                if eval_every and step > 0 and step % eval_every == 0:
                    self.evaluate(step)
                if save_every and step > 0 and step % save_every == 0:
                    save_checkpoint(self.log_dir / "ckpts", step, self.trainer)
                step += 1
        finally:
            it.close()
            loader.close()
        save_checkpoint(self.log_dir / "ckpts", step, self.trainer)
        return self.trainer

    # ------------------------------------------------------------------
    def evaluate(self, step: int, max_batches: int = 10) -> Dict[str, float]:
        if self.val_dataset is None:
            return {}
        fm = FlowMetrics()
        loader = Prefetcher(
            self.val_dataset, batch_size=1, shuffle=False, num_workers=2
        )
        thresh = float(
            self.cfg.validation.obj_is_moving_velocity_thresh
        )
        it = iter(loader)
        try:
            for i, batch in enumerate(it):
                if i >= max_batches:
                    break
                fs = batch_to_flow_sample(batch, self.trainer.device)
                pred_fw, _ = self.trainer.predict_step(fs)
                flow_pred = pred_fw.aggregated_flow[0].cpu().numpy()
                flow_gt = np.asarray(batch["flow_t0_t1"][0])
                pts = np.asarray(batch["pcl_t0"][0, :, :3])
                mask = np.asarray(batch["valid_t0"][0])
                is_moving = compute_moving_mask(
                    pts, flow_gt, np.asarray(batch["odom_t1_t0"][0]), thresh
                )
                fm.update(pts, flow_pred, flow_gt, is_moving, mask)
                if i < 2:  # image summaries (experiment.py:731-770): flow
                    # RGB (pred | gt) side by side + a range image
                    self._log_eval_images(step, i, pts, mask, flow_pred,
                                          flow_gt)
        finally:
            it.close()
            loader.close()
        out = fm.compute()
        self.tb("val", "flow/").add_scalars(out, step)
        return out

    def _log_eval_images(self, step, i, pts, mask, flow_pred, flow_gt):
        from liso_tpu_torch.visu.bbox_image import render_pcl_range_image
        from liso_tpu_torch.visu.flow_image import flow_to_rgb

        h, w = self.bev.grid_size
        cell, _, _ = point_cell_ids(
            torch.from_numpy(pts[:, :2]), self.bev, torch.from_numpy(mask)
        )
        panels = []
        for fl in (flow_pred, flow_gt):
            grid, _ = scatter_mean_grid(
                torch.from_numpy(np.ascontiguousarray(fl[:, :2])), cell,
                self.bev.num_cells)
            panels.append(flow_to_rgb(grid.numpy().reshape(h, w, 2)))
        wtr = self.tb("val", "images/")
        wtr.add_image(
            f"flow_pred_vs_gt/b{i}", np.concatenate(panels, axis=1), step
        )
        wtr.add_image(
            f"range_image/b{i}",
            render_pcl_range_image([pts[mask]])[0],
            step,
        )

    # ------------------------------------------------------------------
    def export_flow(
        self,
        dataset: LidarDataset,
        out_dir,
        world_size: int = 1,
        worker_id: int = 0,
        skip_existing: bool = True,
        max_samples: Optional[int] = None,
    ):
        """run_inference_only: per-sample npz with the 6 flow grids. Each
        npz appears whole or not at all, so a rerun after a crash writes
        the sample that was cut off (the JAX export writes in place, and a
        rerun with skip_existing keeps the truncated file)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        n_done = 0
        for idx in range(len(dataset)):
            if idx % world_size != worker_id:
                continue
            if max_samples is not None and n_done >= max_samples:
                break
            target = out_dir / f"{dataset[idx].sample_id}.npz"
            if skip_existing and target.exists():
                continue
            arrays = export_sample(self.trainer, dataset, idx)
            # whole or not at all: skip_existing trusts a file by its name
            publish(target, lambda tmp: _savez_compressed(tmp, arrays))
            n_done += 1
        return n_done
