"""The mining pass: liso_tpu_torch against liso_tpu on the same inputs (CPU).

- tracker/mining.mine_sequence on tests/test_mining.py's drive with the
  flow-cluster bootstrap (grid 128 over 40 m, 4096 points, 200 smoothing
  iterations);
- train/liso_loop.LisoSelfTraining.mine on an 8-frame SyntheticDataset at
  n_max 4096, grid 64 over 40 m: round 0 (the bootstrap) and round 1 (the
  detector, a random JAX state carried across by
  weights.load_detector_train_state);
- sharded mining: two workers with gather=False, then _gather_worker_dbs,
  give the DBs of one worker.

What must agree: the DB keys, the number of tracks, the track ids of every
sample, the raw (per-frame) detections within 1e-3, and the mined boxes:
dims within 1e-3, positions and yaw within the smoothing's own spread
(tests/test_torch_tracker.py: Adam at lr 0.1 does not settle, and the JAX
smoothing moves by up to 0.07 m when its input moves by one ulp).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.data.dataset import DataCfg as JDataCfg
from liso_tpu.data.synthetic import SyntheticDataset as JSynthetic
from liso_tpu.models import flow_cluster_detector as jfc
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.bev import point_cell_ids as j_cell_ids
from liso_tpu.tracker import mining as jmin
from liso_tpu.train import liso_loop as jloop
from liso_tpu.train.detector_train import DetectorTrainState
from liso_tpu.utils.config import parse_config as j_parse_config
from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.synthetic import SyntheticDataset
from liso_tpu_torch.models import flow_cluster_detector as tfc
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids
from liso_tpu_torch.tracker import mining as tmin
from liso_tpu_torch.tracker.dbs import load_augm_db, load_mined_boxes_db
from liso_tpu_torch.train import liso_loop as tloop
from liso_tpu_torch.utils.config import parse_config
from liso_tpu_torch.weights import load_detector_train_state
from test_mining import make_sequence
from test_torch_modules import random_variables

torch.set_num_threads(1)
RAW_ATOL = 1e-3  # per-frame detections (moments, Kabsch, propagation)
DIMS_ATOL = 1e-3  # refined dims: quantiles of the raw dims
POS_ATOL = 0.1  # m: smoothed positions (the smoothing's own spread)
ROT_ATOL = 0.1  # rad: headings of smoothed displacements of >= 1 m
SMOOTH_ITERS = 200
GRID, RANGE, N_MAX, FRAMES = 64, 40.0, 4096, 8
# config updates on both sides: the random detector's boxes are about
# 0.7 m wide and rarely hold 20 points; its dims head is biased to about
# 3 m boxes (below) and 3 points suffice, so round 1 mines tracks
UPDATES = [["data", "tracking_cfg", "min_points_in_box", "3"],
           ["data", "tracking_cfg", "max_num_boxes_after_nms", "24"]]
DIMS_BIAS = 3.0


def _detect_jax(frame, bev):
    pcl, valid = jnp.asarray(frame.pcl), jnp.asarray(frame.valid)
    cell, _, _ = j_cell_ids(pcl[:, :2], bev, valid)
    return jfc.detect_boxes_from_flow(
        pcl, valid, cell, jnp.asarray(frame.flow),
        jnp.asarray(frame.odom_ta_tb, jnp.float32), pcl, valid,
        jnp.asarray(0.1), bev, jfc.FlowClusterCfg())


def _detect_port(frame, bev):
    pcl, valid = torch.from_numpy(frame.pcl), torch.from_numpy(frame.valid)
    cell, _, _ = point_cell_ids(pcl[:, :2], bev, valid)
    return tfc.detect_boxes_from_flow(
        pcl, valid, cell, torch.from_numpy(frame.flow),
        torch.as_tensor(frame.odom_ta_tb, dtype=torch.float32), pcl, valid,
        0.1, bev, tfc.FlowClusterCfg())


def _assert_same_db(got: dict, want: dict, smoothed: bool = True):
    """Mined (or raw) DBs: keys, track ids, poses and boxes."""
    assert set(got) == set(want)
    pos_tol = POS_ATOL if smoothed else RAW_ATOL
    rot_tol = ROT_ATOL if smoothed else RAW_ATOL
    for sid in want:
        g, w = got[sid], want[sid]
        np.testing.assert_array_equal(g["track_id"], w["track_id"], err_msg=sid)
        assert set(g["raw_box"]) == set(w["raw_box"])
        for k, tol in (("pos", pos_tol), ("rot", rot_tol), ("dims", DIMS_ATOL),
                       ("probs", RAW_ATOL)):
            np.testing.assert_allclose(g["raw_box"][k], w["raw_box"][k],
                                       atol=tol, rtol=0, err_msg=f"{sid} {k}")
        np.testing.assert_allclose(g["lidar_T_box"][..., :3, 3],
                                   w["lidar_T_box"][..., :3, 3], atol=pos_tol,
                                   rtol=0)


@pytest.fixture(scope="module")
def sequence_runs():
    frames = make_sequence()
    cfg_j = jmin.MiningCfg(min_points_in_box=20, smoothing_iters=SMOOTH_ITERS)
    cfg_t = tmin.MiningCfg(min_points_in_box=20, smoothing_iters=SMOOTH_ITERS)
    jbev = JBev((40.0, 40.0), (128, 128))
    bev = BevSetup((40.0, 40.0), (128, 128))
    want = jmin.mine_sequence(frames, lambda f: _detect_jax(f, jbev), cfg_j, jbev)
    got = tmin.mine_sequence(frames, lambda f: _detect_port(f, bev), cfg_t, bev)
    return got, want


def test_mine_sequence_tracks(sequence_runs):
    got, want = sequence_runs
    assert got["num_tracks"] == want["num_tracks"] == 1
    _assert_same_db(got["mined_db"], want["mined_db"])


def test_mine_sequence_raw_detections(sequence_runs):
    got, want = sequence_runs
    _assert_same_db(got["raw_db"], want["raw_db"], smoothed=False)


def test_mine_sequence_snippets(sequence_runs):
    got, want = sequence_runs
    ga, wa = got["augm_db"], want["augm_db"]
    assert len(ga["pcl_in_box_cosy"]) == len(wa["pcl_in_box_cosy"]) >= 6
    assert ga["unique_track_id"] == wa["unique_track_id"]
    for g, w in zip(ga["pcl_in_box_cosy"], wa["pcl_in_box_cosy"]):
        assert g.shape[1] == w.shape[1] == 4
        # points within POS_ATOL of a face may fall on either side
        assert abs(len(g) - len(w)) <= 0.1 * len(w)


def _two_sided_cfgs():
    cfg_j = j_parse_config("liso_tpu/config/liso_config.yml",
                           extra_cfg_args=["centerpoint", "liso"],
                           key_value_updates=UPDATES)
    cfg_t = parse_config(DEFAULT_CFG, ["centerpoint", "liso"], UPDATES)
    return cfg_j, cfg_t


def _loops(tmp_path):
    cfg_j, cfg_t = _two_sided_cfgs()
    jbev, bev = JBev((RANGE, RANGE), (GRID, GRID)), BevSetup((RANGE, RANGE), (GRID, GRID))
    jd = JDataCfg(bev=jbev, n_max=N_MAX, m_max=2 * N_MAX)
    td = DataCfg(bev=bev, n_max=N_MAX, m_max=2 * N_MAX)
    jds, tds = JSynthetic(jd, n_frames=FRAMES, seed=0), SyntheticDataset(td, n_frames=FRAMES, seed=0)
    jl = jloop.LisoSelfTraining(cfg_j, lambda db: jds, None, tmp_path / "jax",
                                data_cfg=jd)
    tl = tloop.LisoSelfTraining(cfg_t, lambda db: tds, None, tmp_path / "port",
                                data_cfg=td, device="cpu")
    for loop in (jl, tl):
        for name in ("mining_cfg_bootstrap", "mining_cfg_detector"):
            setattr(loop, name,
                    getattr(loop, name)._replace(smoothing_iters=SMOOTH_ITERS))
    return jl, tl, jds, tds


def _random_detector_state(jl, tds_sample):
    """A random JAX train state (the dims head biased to about 3 m boxes)
    and its port layout."""
    pts = jnp.asarray(tds_sample.frame_t0.pcl)[None]
    valid = jnp.asarray(tds_sample.frame_t0.valid)[None]
    v = random_variables(jl.trainer.model.init, pts, valid, seed=5)
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    dims_bias = [p for p, _ in flat if "dims" in jax.tree_util.keystr(p)
                 and jax.tree_util.keystr(p).endswith("['bias']")]
    assert dims_bias, "no bias in the dims head"

    def bias(path, x):
        return x + DIMS_BIAS if path in dims_bias else x

    params = jax.tree_util.tree_map_with_path(bias, v["params"])
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = DetectorTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jl.trainer.tx.init(params))
    port = {"step": state.step, "params": state.params,
            "batch_stats": state.batch_stats, "mu": state.opt_state[0].mu,
            "nu": state.opt_state[0].nu, "count": state.opt_state[0].count}
    return state, port


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("liso_mine")
    jl, tl, jds, tds = _loops(tmp)
    out = {}
    jl.mine(jds)
    tl.mine(tds)
    out[0] = (tl.mined_db, jl.mined_db, tl.augm_db, jl.augm_db)
    jstate, port = _random_detector_state(jl, tds[0])
    jl.state, jl.round_idx = jstate, 1
    load_detector_train_state(tl.trainer, port)
    tl.state, tl.round_idx = tl.trainer, 1
    jl.mine(jds)
    tl.mine(tds)
    out[1] = (tl.mined_db, jl.mined_db, tl.augm_db, jl.augm_db)
    out["dirs"] = (tmp / "port", tmp / "jax")
    return out


@pytest.mark.parametrize("round_idx", [0, 1])
def test_liso_mine_rounds(loop_runs, round_idx):
    got, want, gaugm, waugm = loop_runs[round_idx]
    n_tracks = len({int(t) for v in want.values() for t in v["track_id"]})
    assert n_tracks >= (2 if round_idx == 0 else 3), n_tracks
    _assert_same_db(got, want)
    assert len(gaugm["pcl_in_box_cosy"]) == len(waugm["pcl_in_box_cosy"])
    assert gaugm["unique_track_id"] == waugm["unique_track_id"]


@pytest.mark.parametrize("round_idx", [0, 1])
def test_liso_mine_db_files(loop_runs, round_idx):
    """The DB files each package wrote load in the port, with the same
    keys and ids."""
    port_dir, jax_dir = loop_runs["dirs"]
    sub = f"mined_round_{round_idx}"
    got = load_mined_boxes_db(port_dir / sub / "tracked.npz")
    want = load_mined_boxes_db(jax_dir / sub / "tracked.npz")
    _assert_same_db(got, want)
    ga = load_augm_db(port_dir / sub / "augm_db.npy")
    wa = load_augm_db(jax_dir / sub / "augm_db.npy")
    np.testing.assert_array_equal(ga["unique_track_id"], wa["unique_track_id"])
    for f in ("tracking_cfg.yaml", "tracked_box_stats.yaml"):
        assert (port_dir / sub / f).exists()


class _TwoSequences(SyntheticDataset):
    num_sequences = 2

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int = 0):
        half = len(self) // 2
        return list(range(half)) if seq_of_idx == 0 else list(range(half, len(self)))


def test_sharded_mining_gathers_the_single_worker_db(tmp_path):
    _, cfg = _two_sided_cfgs()
    bev = BevSetup((RANGE, RANGE), (GRID, GRID))
    dcfg = DataCfg(bev=bev, n_max=N_MAX, m_max=2 * N_MAX)
    ds = _TwoSequences(dcfg, n_frames=FRAMES, seed=0)
    loops = []
    for name, (ws, wid) in {"one": (1, 0), "w0": (2, 0), "w1": (2, 1)}.items():
        loop = tloop.LisoSelfTraining(
            cfg, lambda db: ds, None, tmp_path / ("one" if ws == 1 else "shared"),
            data_cfg=dcfg, world_size=ws, worker_id=wid, device="cpu")
        loop.mining_cfg_bootstrap = loop.mining_cfg_bootstrap._replace(
            smoothing_iters=SMOOTH_ITERS, min_track_age=2)
        loop.mine(ds, gather=False)
        loops.append(loop)
    one = loops[0]
    mined, augm = loops[1]._gather_worker_dbs(
        tmp_path / "shared" / "mined_round_0", 2, poll_s=0.01, timeout_s=10)
    assert set(mined) == set(one.mined_db) == {f"synth0_{t:04d}" for t in range(FRAMES)}
    for sid in mined:
        for k in ("track_id", "lidar_T_box"):
            np.testing.assert_array_equal(mined[sid][k], one.mined_db[sid][k])
    assert len(augm["pcl_in_box_cosy"]) == len(one.augm_db["pcl_in_box_cosy"]) > 0
    assert sum(len(v["track_id"]) for v in loops[1].mined_db.values()) > 0
    assert sum(len(v["track_id"]) for v in loops[2].mined_db.values()) > 0


def test_liso_self_training_device_and_item_3(tmp_path, monkeypatch):
    _, cfg = _two_sided_cfgs()
    dcfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path, data_cfg=dcfg)
    loop = tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path,
                                  data_cfg=dcfg, device="cpu")
    assert all(p.device.type == "cpu" for p in loop.trainer.params.values())
    # the rounds loop is ported (tests/test_torch_liso_rounds.py): restore
    # finds no checkpoint here
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        loop.restore(tmp_path / "ckpts")
    assert loop.validate(0) == {}  # no val set: nothing to evaluate
    # ROADMAP section A item 3 is ported: the non-baseline CenterPoint
    # builds, and predicts at /8
    cfg.network.centerpoint.use_baseline_parameters = False
    loop = tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path,
                                  data_cfg=dcfg, device="cpu")
    assert loop.trainer.model.model.out_downsample_factor == 8
