"""The rounds loop: liso_tpu_torch against liso_tpu on the same inputs (CPU).

Both packages run LisoSelfTraining.run on an 8-frame SyntheticDataset at
n_max 4096, grid 64 over 40 m (tests/test_torch_mining.py's size), with
steps_per_round 3 and drop_net_weights_every_nth_round 1: round 0's
bootstrap mining at step 0, the detector's mining and the weight reset at
step 3, 6 steps in all, copy-paste augmentation on. Cuts for the CPU's
sake, the same on both sides: 20 jerk-smoothing steps per track (where the
two packages agree to 1e-5) and a pre-NMS cap of PRE_MAX_BOXES boxes.

The two random streams differ, so the port's `_init_detector` is patched
to load JAX's init for the same seed (PRNGKey(seed), the dims head's bias
raised by DIMS_BIAS as in the mining tests, on both sides) through
weights.load_detector_train_state. At each boundary the port mines, and
its DBs are held to JAX's; round 1 mines with JAX's trained detector
carried in, since the two sides' training drifts apart and a box near a
threshold flips a track. Then JAX's DBs are carried into the port's loop,
so that both train on the same targets and paste the same snippets (the
snippets' point counts, and with them the draws from `rng`, follow the
boxes' last bits). What must agree:
- the seeds and steps of every detector init (the reset at step 3);
- the mined DB of each round: the same keys and track ids, boxes within
  the mining tests' raw-detection limit (test_torch_mining.RAW_ATOL, 1e-3);
- the loss terms of each step: within LOSS_RTOL at steps 0 and 3, where
  both sides start from the same weights, and within DRIFT_RTOL after,
  where AdamW's first updates carry the two sides' float noise;
- `_prepare_batch` bitwise (points, validity and targets) from the same
  RandomState and batch;
- save / restore bitwise, a half-written round directory skipped, and the
  round_idx of a resumed run equal to JAX's.
"""
import copy
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.cli.slim_cli import make_train_dataset as j_make_train_dataset
from liso_tpu.data.dataset import DataCfg as JDataCfg
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.train import liso_loop as jloop
from liso_tpu.utils.config import parse_config as j_parse_config
from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.cli.slim_cli import make_train_dataset
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.tracker.dbs import finalize_augm_db, load_augm_db
from liso_tpu_torch.train import liso_loop as tloop
from liso_tpu_torch.utils.config import parse_config
from liso_tpu_torch.weights import load_detector_train_state
from test_torch_augmentation import assert_same, augm_db
from test_torch_mining import (
    DIMS_BIAS,
    GRID,
    N_MAX,
    RANGE,
    UPDATES,
    _assert_same_db,
)

torch.set_num_threads(1)
SMOOTH_ITERS = 20
PRE_MAX_BOXES = 64
STEPS_PER_ROUND, TOTAL_STEPS = 3, 6
LOSS_RTOL = 1e-4  # the detector step's (tests/test_torch_detector_train.py)
# after an update the loss terms carry the two sides' float noise, grown by
# AdamW's first steps (about lr * sign(g): a gradient element near 0 whose
# sign differs moves its weight by a whole lr). Measured (CPU): JAX against
# the port up to 1.35e-2 (loss/pos at step 5, loss/rot 1.24e-2 at step 2);
# the port against itself at 1 and 4 threads up to 2.85e-2 (loss/dims at
# step 5). DRIFT_RTOL stands above both.
DRIFT_RTOL = 5e-2
RUN_UPDATES = UPDATES + [
    ["optimization", "rounds", "steps_per_round", str(STEPS_PER_ROUND)],
    ["optimization", "rounds", "drop_net_weights_every_nth_round", "1"],
    ["optimization", "num_training_steps", str(TOTAL_STEPS)],
    ["validation", "val_every_n_steps", "0"],
    ["checkpoint", "save_model_every", str(STEPS_PER_ROUND)],
    ["data", "num_workers", "2"],
]
LOSS_KEYS = ("loss/probs", "loss/rot", "loss/dims", "loss/pos", "loss/total")


def _cfgs():
    cfg_j = j_parse_config("liso_tpu/config/liso_config.yml",
                           extra_cfg_args=["centerpoint", "liso"],
                           key_value_updates=RUN_UPDATES)
    cfg_t = parse_config(DEFAULT_CFG, ["centerpoint", "liso"], RUN_UPDATES)
    return cfg_j, cfg_t


def _loops(tmp, val=False):
    """A JAX and a port LisoSelfTraining at the test size, each with its
    package's make_train_dataset as the factory."""
    cfg_j, cfg_t = _cfgs()
    jd = JDataCfg(bev=JBev((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX,
                  m_max=2 * N_MAX)
    td = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX,
                 m_max=2 * N_MAX)
    jl = jloop.LisoSelfTraining(
        cfg_j, lambda db: j_make_train_dataset(cfg_j, jd, True, db), None,
        tmp / "jax", data_cfg=jd)
    tl = tloop.LisoSelfTraining(
        cfg_t, lambda db: make_train_dataset(cfg_t, td, True, db),
        make_train_dataset(cfg_t, td, True) if val else None,
        tmp / "port", data_cfg=td, device="cpu")
    for loop in (jl, tl):
        loop.trainer.pre_max_boxes = PRE_MAX_BOXES
        for name in ("mining_cfg_bootstrap", "mining_cfg_detector"):
            setattr(loop, name,
                    getattr(loop, name)._replace(smoothing_iters=SMOOTH_ITERS))
    return jl, tl, make_train_dataset(cfg_t, td, True)


def _port_layout(state):
    """A JAX DetectorTrainState as weights.load_detector_train_state takes
    it (numpy)."""
    adam = state.opt_state[0]
    tree = {"step": state.step, "params": state.params,
            "batch_stats": state.batch_stats, "mu": adam.mu, "nu": adam.nu,
            "count": adam.count}
    return jax.tree_util.tree_map(np.asarray, tree)


def _bias_dims(state):
    """The init with the dims head's bias raised by DIMS_BIAS, as the
    mining tests' random detector (boxes of about 3 m, which hold points, so
    that round 1 mines tracks)."""
    def bias(path, x):
        key = jax.tree_util.keystr(path)
        return x + DIMS_BIAS if "dims" in key and key.endswith("['bias']") else x

    return state.replace(
        params=jax.tree_util.tree_map_with_path(bias, state.params))


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """Both packages' runs, JAX's first; see the module docstring."""
    tmp = tmp_path_factory.mktemp("liso_rounds")
    jl, tl, tds = _loops(tmp)
    sample = tds[0]
    pts = jnp.asarray(sample.frame_t0.pcl)[None]
    valid = jnp.asarray(sample.frame_t0.valid)[None]
    rec = {"jax_metrics": [], "port_metrics": [], "jax_inits": [],
           "port_inits": [], "jax_dbs": {}, "port_dbs": {},
           "jax_detectors": {}}

    # JAX: record every step's metrics, every init and every round's DBs
    # the init under jit: the same bits as JAX's eager init, in a fraction
    # of its time
    j_step, j_init, j_mine = (jl.trainer.train_step,
                              jax.jit(jl.trainer.init_state), jl.mine)

    def j_train(*a, **k):
        state, metrics = j_step(*a, **k)
        rec["jax_metrics"].append(_floats(metrics))
        return state, metrics

    inits = {}  # JAX's init states by key, for the port's inits

    def j_init_state(rng, *a, **k):
        rec["jax_inits"].append((len(rec["jax_metrics"]), np.asarray(rng)))
        state = _bias_dims(j_init(rng, *a, **k))
        inits[tuple(np.asarray(rng).tolist())] = _port_layout(state)
        return state

    def j_mine_rec(dataset, *a, **k):
        r = jl.round_idx
        if jl.state is not None:  # the detector this round mines with
            rec["jax_detectors"][r] = _port_layout(jl.state)
        j_mine(dataset, *a, **k)
        rec["jax_dbs"][r] = copy.deepcopy((jl.mined_db, jl.augm_db))

    jl.trainer.train_step, jl.trainer.init_state = j_train, j_init_state
    jl.mine = j_mine_rec
    rec["jax_hist"] = jl.run(total_steps=TOTAL_STEPS)

    # the port: JAX's init for each seed, its own mining held to JAX's and
    # then JAX's DBs carried in
    t_step, t_mine = tl.trainer.train_step, tl.mine

    def t_train(*a, **k):
        metrics = t_step(*a, **k)
        rec["port_metrics"].append(_floats(metrics))
        return metrics

    def t_init(seed):
        rec["port_inits"].append((len(rec["port_metrics"]), seed))
        key = jax.random.PRNGKey(seed)
        state = inits.get(tuple(np.asarray(key).tolist()))
        if state is None:  # a seed that JAX did not draw
            state = _port_layout(_bias_dims(j_init(key, pts, valid)))
        load_detector_train_state(tl.trainer, state)
        tl.state = tl.trainer

    def t_mine_rec(dataset, *a, **k):
        r = tl.round_idx
        own = None
        if r in rec["jax_detectors"]:
            # JAX's trained detector mines: the two sides' detectors differ
            # by the drift of their training, and a box near a threshold
            # (confidence, points in the box, track matching) would flip a
            # track (6 of 39 boxes did, uncarried)
            own = copy.deepcopy(tl.trainer.state_dict())
            load_detector_train_state(tl.trainer, rec["jax_detectors"][r])
        t_mine(dataset, *a, **k)
        if own is not None:
            tl.trainer.load_state_dict(own)
        rec["port_dbs"][r] = copy.deepcopy((tl.mined_db, tl.augm_db))
        tl.mined_db, tl.augm_db = copy.deepcopy(rec["jax_dbs"][r])
        tl._augm_db_final = None

    saved = {}

    def t_save(step):
        tloop.LisoSelfTraining.save(tl, step)
        saved[step] = copy.deepcopy(tl.trainer.state_dict())

    tl.trainer.train_step, tl._init_detector = t_train, t_init
    tl.mine, tl.save = t_mine_rec, t_save
    rec["port_hist"] = tl.run(total_steps=TOTAL_STEPS)
    rec.update(saved=saved, tmp=tmp, loops=(jl, tl), tds=tds)
    return rec


def test_detector_inits_and_reset(rounds):
    seed = 0
    assert rounds["port_inits"] == [(0, seed + 1), (STEPS_PER_ROUND, seed + 2)]
    assert [s for s, _ in rounds["jax_inits"]] == [0, STEPS_PER_ROUND]
    for (_, key), (_, s) in zip(rounds["jax_inits"], rounds["port_inits"]):
        np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(s)))
    jl, tl = rounds["loops"]
    assert jl.round_idx == tl.round_idx == 2


@pytest.mark.parametrize("round_idx", [0, 1])
def test_mined_db_at_each_boundary(rounds, round_idx):
    got, gaugm = rounds["port_dbs"][round_idx]
    want, waugm = rounds["jax_dbs"][round_idx]
    _assert_same_db(got, want, smoothed=False)
    assert len(gaugm["boxes"]) == len(waugm["boxes"])
    assert gaugm["unique_track_id"] == waugm["unique_track_id"]
    if round_idx == 0:  # the paste path runs on round 0's snippets
        assert len(waugm["boxes"]) > 0


@pytest.mark.parametrize("step", range(TOTAL_STEPS))
def test_loss_per_step(rounds, step):
    got, want = rounds["port_metrics"][step], rounds["jax_metrics"][step]
    rtol = LOSS_RTOL if step % STEPS_PER_ROUND == 0 else DRIFT_RTOL
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(rounds["port_hist"][step],
                               rounds["jax_hist"][step], rtol=rtol)
    assert want["loss/total"] > 0


def test_checkpoints_and_restore(rounds):
    """The run saved steps 3 and 6; restore gives step 6 bitwise, with the
    newest complete round's DBs (those mine wrote)."""
    jl, tl = rounds["loops"]
    run_dir = rounds["tmp"] / "port"
    assert sorted(int(p.name) for p in (run_dir / "ckpts").iterdir()
                  if p.name.isdigit()) == [STEPS_PER_ROUND, TOTAL_STEPS]
    assert rounds["saved"][TOTAL_STEPS]["optimizer"]["count"] == STEPS_PER_ROUND
    _, fresh, _ = _loops(rounds["tmp"] / "fresh")
    assert fresh.restore(run_dir / "ckpts") == TOTAL_STEPS
    assert fresh.state is fresh.trainer
    assert_same_state(fresh.trainer.state_dict(), tl.trainer.state_dict())
    assert_same_state(fresh.trainer.state_dict(), rounds["saved"][TOTAL_STEPS])
    own_mined, own_augm = rounds["port_dbs"][1]
    assert_same(fresh.mined_db, own_mined)
    stacked = np.load(run_dir / "mined_round_1" / "augm_db.npy",
                      allow_pickle=True).item()
    assert_same(stacked, finalize_augm_db(own_augm))
    assert_same(fresh._augm_db_final,
                load_augm_db(run_dir / "mined_round_1" / "augm_db.npy"))


def assert_same_state(a, b, path="state"):
    """Train states bitwise: tensors by dtype, shape and bits."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), path
    else:
        assert a == b, path


@pytest.mark.parametrize("half_written", ["empty_dir", "truncated",
                                          "no_augm_db", "truncated_augm_db"])
def test_restore_skips_a_half_written_round(rounds, tmp_path, half_written):
    """A round directory that an interrupted mine left behind: without a
    readable tracked.npz it is skipped; with tracked.npz but no readable
    augm_db.npy its boxes are taken and no snippets (as in JAX, which
    raises on the truncated files instead: BadZipFile, UnpicklingError)."""
    import shutil

    src = rounds["tmp"] / "port"
    dst = tmp_path / "run"
    shutil.copytree(src / "ckpts", dst / "ckpts")
    for r in (0, 1):
        shutil.copytree(src / f"mined_round_{r}", dst / f"mined_round_{r}")
    half = dst / "mined_round_2"
    half.mkdir()

    def copy_truncated(name, to):
        data = (src / "mined_round_0" / name).read_bytes()
        (half / to).write_bytes(data[: len(data) // 2])

    if half_written == "truncated":
        copy_truncated("tracked.npz", "tracked.npz")
    elif half_written != "empty_dir":
        shutil.copy(src / "mined_round_0" / "tracked.npz", half / "tracked.npz")
    if half_written == "truncated_augm_db":
        copy_truncated("augm_db.npy", "augm_db.npy")
    _, fresh, _ = _loops(tmp_path / "fresh")
    fresh.restore(dst / "ckpts")
    skipped = half_written in ("empty_dir", "truncated")
    assert_same(fresh.mined_db, rounds["port_dbs"][1 if skipped else 0][0])
    if skipped:
        assert_same(fresh._augm_db_final,
                    load_augm_db(src / "mined_round_1" / "augm_db.npy"))
    else:
        assert fresh._augm_db_final is None


@pytest.mark.parametrize("start_step", [1, 2, 3, 4, 5])
def test_resumed_round_idx_matches_jax(rounds, tmp_path, start_step):
    """run(start_step=k) with nothing left to train: the round_idx it
    resumes at, against the JAX loop's."""
    jl, tl, _ = _loops(tmp_path)
    for loop in (jl, tl):
        loop.mined_db = rounds["jax_dbs"][0][0]
        loop.run(total_steps=start_step, start_step=start_step)
    assert tl.round_idx == jl.round_idx == -(-start_step // STEPS_PER_ROUND)
    assert not (tmp_path / "port" / "ckpts").exists()  # no state, no save


def test_resumed_run_continues_the_round(rounds, tmp_path):
    """Restore step 3 and run steps 4 and 5: no mining (the next boundary
    is 6), round_idx 2 as in the fresh run, the state trained on from the
    checkpoint, a checkpoint at 6."""
    import shutil

    src = rounds["tmp"] / "port"
    dst = tmp_path / "run"
    shutil.copytree(src / "ckpts" / str(STEPS_PER_ROUND),
                    dst / "ckpts" / str(STEPS_PER_ROUND))
    shutil.copy(src / "ckpts" / "format_version", dst / "ckpts")
    for r in (0, 1):
        shutil.copytree(src / f"mined_round_{r}", dst / f"mined_round_{r}")
    _, tl, _ = _loops(tmp_path / "resume")
    step = tl.restore(dst / "ckpts")
    assert step == STEPS_PER_ROUND
    assert_same_state(tl.trainer.state_dict(),
                      rounds["saved"][STEPS_PER_ROUND])
    mined = []
    tl.mine = lambda *a, **k: mined.append(tl.round_idx)
    hist = tl.run(total_steps=TOTAL_STEPS, start_step=step + 1)
    assert mined == [] and tl.round_idx == 2 and len(hist) == 2
    assert all(np.isfinite(hist))
    assert tl.trainer.step == rounds["saved"][STEPS_PER_ROUND]["step"] + 2
    assert (tmp_path / "resume" / "port" / "ckpts" / str(TOTAL_STEPS)).exists()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_batch_bitwise(rounds, tmp_path, seed):
    """The same batch, augmentation DB and RandomState through both
    packages' _prepare_batch: the pasted clouds, validity and target slots
    bitwise, and the same draws."""
    jl, tl, tds = _loops(tmp_path)
    mined = rounds["jax_dbs"][0][0]
    ds = make_train_dataset(tl.cfg, tds.cfg, True, mined)
    loader = Prefetcher(ds, batch_size=2, shuffle=True, seed=seed,
                        num_workers=0)
    batch = next(iter(loader))
    # every 25th point: the drive's clouds leave no spot 2 m from every
    # point (min_center_dist_from_occupied_m), a sparse one does
    batch["valid_t0"] &= np.arange(N_MAX) % 25 == 0
    db = augm_db(seed)
    for loop in (jl, tl):
        loop._augm_db_final = copy.deepcopy(db)
        loop.rng = np.random.RandomState(seed)
    jp, jv, jb = jl._prepare_batch(batch)
    tp, tv, tb = tl._prepare_batch(batch)
    assert_same(tp.numpy(), np.asarray(jp))
    assert_same(tv.numpy(), np.asarray(jv))
    for f in ("pos", "dims", "rot", "probs", "velo", "valid", "class_id",
              "difficulty"):
        assert_same(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    sa, sb = tl.rng.get_state(), jl.rng.get_state()
    assert np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]
    # boxes were pasted: more valid points and target slots than the batch
    assert tv.sum() > batch["valid_t0"].sum()
    assert tb.valid.sum() > batch["target_boxes"]["valid"].sum()


@pytest.mark.parametrize("case", ["no_db", "augm_off", "filtered_db"])
def test_prepare_batch_without_paste(rounds, tmp_path, case):
    """No paste and no draw: no DB, box augmentation off, or a restored DB
    that the loader's filter emptied."""
    jl, tl, tds = _loops(tmp_path)
    batch = next(iter(Prefetcher(tds, batch_size=2, num_workers=0)))
    for loop in (jl, tl):
        if case == "augm_off":
            loop.augm_db = copy.deepcopy(rounds["jax_dbs"][0][1])
            loop.cfg.data.augmentation.boxes.active = False
        elif case == "filtered_db":
            loop._augm_db_final = augm_db(0, n=0)
    jp, jv, jb = jl._prepare_batch(batch)
    tp, tv, tb = tl._prepare_batch(batch)
    assert_same(tp.numpy(), np.asarray(jp))
    assert_same(tv.numpy(), np.asarray(jv))
    assert_same(tp.numpy(), batch["pcl_t0"])
    assert_same(tb.valid.numpy(), batch["target_boxes"]["valid"])
    assert tl.rng.get_state()[2] == np.random.RandomState(0).get_state()[2]
    np.testing.assert_array_equal(tl.rng.get_state()[1],
                                  np.random.RandomState(0).get_state()[1])


def test_init_detector_redraws_weights_and_restarts_adamw(tmp_path):
    """After steps, _init_detector(seed) gives what a fresh trainer's
    init_weights(model, seed) gives, batch-norm statistics included, with
    AdamW's moments, count and step at 0."""
    _, tl, tds = _loops(tmp_path)
    batch = next(iter(Prefetcher(tds, batch_size=2, num_workers=0)))
    pts, valid, target = tl._prepare_batch(batch)
    tl._init_detector(4)
    assert tl.state is tl.trainer
    for _ in range(2):
        tl.trainer.train_step(pts, valid, target)
    assert tl.trainer.count == 2
    tl._init_detector(5)
    want = tloop.LisoSelfTraining(tl.cfg, lambda db: None, None, tmp_path / "w",
                                  data_cfg=tl.data_cfg, device="cpu").trainer
    init_weights(want.model, 5)
    assert_same_state(tl.trainer.state_dict(), want.state_dict())
    assert tl.trainer.count == tl.trainer.step == 0


def _sync_loops(tmp_path, perturb=False):
    _, cfg = _cfgs()
    dcfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX)
    loops = [tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path,
                                    data_cfg=dcfg, world_size=2, worker_id=w,
                                    device="cpu")
             for w in (0, 1)]
    for loop in loops:
        loop.state = loop.trainer
    if perturb:
        with torch.no_grad():
            next(iter(loops[1].trainer.params.values())).view(-1)[0] += 1e-6
    return loops


def _in_both(loops, step, **kw):
    """_assert_replicas_in_sync on both workers at once; each one's
    exception (or None)."""
    errors = [None, None]

    def call(i):
        try:
            loops[i]._assert_replicas_in_sync(step, **kw)
        except Exception as e:  # handed to the test
            errors[i] = e

    t = threading.Thread(target=call, args=(1,))
    t.start()
    call(0)
    t.join(timeout=30)
    assert not t.is_alive()
    return errors


def test_replicas_in_sync_pass(tmp_path):
    loops = _sync_loops(tmp_path)
    assert _in_both(loops, 4, poll_s=0.01, timeout_s=10) == [None, None]
    digests = {(tmp_path / "param_sync_step_4" / f"digest_worker{w}").read_text()
               for w in (0, 1)}
    assert len(digests) == 1


def test_replicas_out_of_sync_raise(tmp_path):
    loops = _sync_loops(tmp_path, perturb=True)
    errors = _in_both(loops, 5, poll_s=0.01, timeout_s=10)
    assert all(isinstance(e, RuntimeError) for e in errors), errors
    assert "replica divergence at step 5" in str(errors[0])


def test_replicas_missing_peer_times_out(tmp_path):
    loop = _sync_loops(tmp_path)[0]
    with pytest.raises(TimeoutError, match=r"workers \[1\]"):
        loop._assert_replicas_in_sync(6, poll_s=0.01, timeout_s=0.1)


def test_replicas_in_sync_single_worker_is_a_no_op(tmp_path):
    _, cfg = _cfgs()
    dcfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX)
    loop = tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path,
                                  data_cfg=dcfg, device="cpu")
    loop.state = loop.trainer
    loop._assert_replicas_in_sync(0, timeout_s=0.0)
    assert not list(tmp_path.glob("param_sync_step_*"))
