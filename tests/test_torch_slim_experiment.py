"""The port's SLIM experiment path (liso_tpu_torch.train.slim_experiment,
utils/checkpoint, cli/slim_cli) against the JAX package's, on the CPU at
grid 64 over 40 m, 2048 points per frame, 2 RAFT iterations, slim_liso:

- the optimizer step (Adam, and gradient clipping on both optimizers)
  against optax, given the same gradients;
- the flow export of one sample from the same random flax state, carried
  across by weights.load_slim_train_state (one JAX compile of predict_step,
  under LISO_CORR_PATH=fused as the other parity tests run it): same npz
  keys and shapes, flow within the serving tolerance, dynamicness within
  1e-3, the static threshold exact;
- each package's dataset reading the other's npz;
- the checkpoint round trip and its config sanity check;
- slim_cli --fast-test --device cpu: train, save, export from the
  checkpoint.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.cli.common import DEFAULT_CFG as J_CFG
from liso_tpu.data.dataset import DataCfg as JDataCfg
from liso_tpu.data.synthetic import SyntheticDataset as JSynthetic
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.train.slim_experiment import SlimExperiment as JExperiment
from liso_tpu.train.slim_experiment import batch_to_flow_sample as j_batch
from liso_tpu.train.slim_train import SlimTrainer as JTrainer
from liso_tpu.train.slim_train import SlimTrainState
from liso_tpu.data.dataset import collate as j_collate
from liso_tpu.models.slim import MovAvgState as JMovAvg
from liso_tpu.utils.config import parse_config as j_parse
from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.synthetic import SyntheticDataset
from liso_tpu_torch.models.slim import movavg_value
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.train.slim_experiment import SlimExperiment
from liso_tpu_torch.train.slim_train import SlimTrainer
from liso_tpu_torch.utils import checkpoint, trace
from liso_tpu_torch.utils.config import parse_config, save_config
from liso_tpu_torch.weights import load_slim_train_state
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE, N_MAX, ITERS = 64, 40.0, 2048, 2
KV = [["SLIM", "model", "num_iters", str(ITERS)]]
SLIM_SPANS = ("slim.step", "slim.wait", "slim.loss_and_grads",
              "slim.forward", "slim.loss", "slim.backward", "slim.optimizer")
FLOW_ATOL = 2e-3  # m, the serving path's tolerance
DYN_ATOL = 1e-3
OPT_RTOL = 1e-6


def _find(state, field):
    """The optax state node that has `field` (ScaleByAdamState,
    ScaleByRmsState) inside a chain's nested tuples."""
    if hasattr(state, field):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _find(s, field)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("optimizer,clip", [("adam", 0.0), ("adam", 0.05),
                                            ("rmsprop", 0.05)])
def test_optimizer_step_matches_optax(optimizer, clip, monkeypatch):
    """Five train_step updates from given gradients (norms above and below
    the clip) against the JAX trainer's optax chain."""
    kw = dict(num_iters=1, optimizer=optimizer, grad_clip_norm=clip,
              initial_lr=1e-3, warmup_steps=2, train_steps=10)
    tt = SlimTrainer(BevSetup((RANGE, RANGE), (32, 32)), device="cpu", **kw)
    tx = JTrainer(JBev((RANGE, RANGE), (32, 32)), **kw).tx
    # the three largest parameter tensors and every 12th (the update is
    # per element; eager JAX compiles each op per shape); the JAX tree is a
    # list in the port's order, so that both sum the global norm over the
    # tensors in one order
    names = [k for i, (k, p) in enumerate(tt.params.items())
             if i % 12 == 0 or p.numel() > 200_000]
    for d in (tt.params, tt.nu, tt.mu):
        for k in set(d) - set(names):
            del d[k]
    jp = [jnp.asarray(np.array(tt.params[k].detach().numpy())) for k in names]
    state = tx.init(jp)
    rng = np.random.RandomState(5)
    n = sum(p.numel() for p in tt.params.values())
    assert 1e5 < n and 4 * n < 2**24
    clipped = []
    for step in range(5):
        # g = k 2^-e with k in -2..2: every square and every partial sum of
        # squares is exact in fp32, so both sides take the same norm in any
        # order; the global norm spans about 3e-3 .. 3e-1 over the steps
        # (the clip at 0.05 triggers on some)
        scale = 2.0 ** -rng.randint(12, 20)
        grads = [(scale * rng.randint(-2, 3, tt.params[k].shape)).astype(
            np.float32) for k in names]
        fake = [torch.from_numpy(g) for g in grads]
        monkeypatch.setattr(tt, "_loss_and_grads", lambda *a: (
            torch.tensor(1.0), tt.movavg, {}, fake))
        m = tt.train_step(None)
        clipped.append(float(m["grad_norm"]) >= clip)
        # eager, op by op: under jit XLA may contract b1 mu + (1 - b1) g
        # into one fma, which rounds a cancelling sum differently
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        moments = _find(state, "nu")
        for i, k in enumerate(names):
            np.testing.assert_allclose(tt.params[k].detach().numpy(),
                                       np.asarray(jp[i]), rtol=OPT_RTOL,
                                       atol=1e-9, err_msg=f"step {step} {k}")
            np.testing.assert_allclose(tt.nu[k].numpy(),
                                       np.asarray(moments.nu[i]),
                                       rtol=OPT_RTOL, atol=1e-30)
            if optimizer == "adam":
                np.testing.assert_allclose(tt.mu[k].numpy(),
                                           np.asarray(moments.mu[i]),
                                           rtol=OPT_RTOL, atol=1e-30)
        if optimizer == "adam":
            assert tt.count == int(moments.count) == step + 1
        np.testing.assert_allclose(
            float(m["grad_norm"]),
            float(jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(g)))
                               for g in grads))), rtol=1e-6)
    assert tt.step == 5
    if clip:
        assert 0 < sum(clipped) < 5, clipped


def test_clip_by_global_norm_is_optax():
    """(g / norm) * max_norm when norm >= max_norm (no epsilon, no clamp),
    bit for bit with optax."""
    import optax

    from liso_tpu_torch.train.slim_train import clip_by_global_norm, global_norm

    rng = np.random.RandomState(6)
    grads = [rng.randn(7, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        tg = [torch.from_numpy(g) for g in grads]
        got = clip_by_global_norm(tg, global_norm(tg), max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        if max_norm == 100.0:
            assert all(torch.equal(a, b) for a, b in zip(got, tg))


def _cfgs():
    return (j_parse(str(J_CFG), ["slim_liso"], KV),
            parse_config(str(DEFAULT_CFG), ["slim_liso"], KV))


def _datasets():
    base = dict(n_max=N_MAX, m_max=4 * N_MAX, use_skip_frames="never")
    jd = JSynthetic(JDataCfg(bev=JBev((RANGE, RANGE), (GRID, GRID)), **base),
                    n_frames=2, seed=0, n_points=3000)
    td = SyntheticDataset(DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)),
                                  **base), n_frames=2, seed=0, n_points=3000)
    return jd, td


def _no_tensorboard(mp):
    """Both packages' TBFactory fall back to a no-op writer without
    tensorboard: spare the tests its import (seconds)."""
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One sample exported by each package from the same random state,
    with a threshold state whose cumulative sums are exact in fp32."""
    tmp = tmp_path_factory.mktemp("exports")
    mp = pytest.MonkeyPatch()
    mp.setenv("LISO_CORR_PATH", "fused")
    _no_tensorboard(mp)
    try:
        jcfg, tcfg = _cfgs()
        jd, td = _datasets()
        jexp = JExperiment(jcfg, JBev((RANGE, RANGE), (GRID, GRID)), jd, None,
                           tmp / "jax")
        fs = j_batch(j_collate([jd[0]]))
        v = random_variables(jexp.trainer.model.init, fs.pcl_t0.pcl,
                             fs.pcl_t0.valid, fs.pcl_t1.pcl, fs.pcl_t1.valid,
                             seed=31)
        rng = np.random.RandomState(7)
        importance = rng.randint(-3, 4, 100_000).astype(np.float32)
        importance[61_234] = -1e4  # one clear minimum of the cumulative sum
        importance[61_235] = 1e4
        movavg = {"importance": importance,
                  "bias_counter": np.float32(1.0),
                  "update_weight": np.float32(1e-6),
                  "start_value": np.float32(0.5)}
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        jexp.state = SlimTrainState(
            step=jnp.asarray(3, jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            opt_state=jexp.trainer.tx.init(params),
            movavg=JMovAvg(**{k: jnp.asarray(x) for k, x in movavg.items()}))
        assert jexp.export_flow(jd, tmp / "jax_preds", max_samples=1) == 1
        texp = SlimExperiment(tcfg, BevSetup((RANGE, RANGE), (GRID, GRID)),
                              td, None, tmp / "port", device="cpu")
    finally:
        mp.undo()
    load_slim_train_state(texp.trainer, {
        "step": 3, "params": v["params"], "batch_stats": v["batch_stats"],
        "nu": jax.tree_util.tree_map(np.asarray, v["params"]),
        "movavg": movavg})
    assert texp.export_flow(td, tmp / "port_preds", max_samples=1) == 1
    return tmp, jd, td


def test_export_flow_matches_jax(exports):
    tmp, _, _ = exports
    [jf], [tf] = sorted((tmp / "jax_preds").glob("*.npz")), sorted(
        (tmp / "port_preds").glob("*.npz"))
    assert jf.name == tf.name == "synth0_0000.npz"
    want, got = np.load(jf), np.load(tf)
    assert sorted(want.files) == sorted(got.files)
    assert len(got.files) == 14
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k.startswith("bev_raw_flow"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FLOW_ATOL,
                                       err_msg=k)
        elif k.startswith("bev_dynamicness"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=DYN_ATOL,
                                       err_msg=k)
        else:
            assert np.array_equal(got[k], want[k]), k
    assert float(got["static_threshold"]) == pytest.approx(0.61235, abs=1e-5)
    assert np.abs(got["bev_raw_flow_t0_t1"]).max() > 0.05  # not all empty


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_datasets_read_either_export_bitwise(exports, reader):
    """The flow source `slim` of each package over the other's npz gives
    the per-point flow that the npz's own package reads."""
    tmp, jd, td = exports
    own, other = ("jax", "port") if reader == "jax" else ("port", "jax")
    flows = {}
    for pkg, ds in (("jax", jd), ("port", td)):
        cfg = ds.cfg._replace(flow_source="slim")
        cls = type(ds)
        for src in (own, other):
            d = cls(cfg, n_frames=2, seed=0, n_points=3000,
                    pred_flow_path=tmp / f"{src}_preds")
            s = d.get_pair(0, "t0", "t2")
            flows[pkg, src] = (s.flow_t0_t1, s.flow_t1_t0)
    for src in (own, other):
        for a, b in zip(flows["jax", src], flows["port", src]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    gt = jd.get_pair(0, "t0", "t2").flow_t0_t1
    assert not np.array_equal(flows["port", other][0], gt)


def _state_diff(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [d for k in a for d in _state_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    return [] if a == b else [path]


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_checkpoint_round_trip_is_exact(tmp_path, optimizer, capsys):
    bev = BevSetup((RANGE, RANGE), (32, 32))
    kw = dict(num_iters=1, optimizer=optimizer, device="cpu")
    a = SlimTrainer(bev, seed=1, **kw)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for d in (a.nu, a.mu):
            for t in d.values():
                t.copy_(torch.rand(t.shape, generator=g))
        for name, buf in a.model.named_buffers():
            if buf.dtype == torch.float32:
                buf.copy_(torch.rand(buf.shape, generator=g))
    a.step, a.count = 11, 11 if optimizer == "adam" else 0
    a.movavg = a.movavg._replace(
        importance=torch.rand(100_000, generator=g),
        bias_counter=torch.tensor(2.5))
    checkpoint.save_checkpoint(tmp_path / "ckpts", 11, a)
    checkpoint.save_checkpoint(tmp_path / "ckpts", 4, a)
    assert checkpoint.latest_step(tmp_path / "ckpts") == 11
    b = SlimTrainer(bev, seed=2, **kw)
    assert _state_diff(a.state_dict(), b.state_dict())
    checkpoint.restore_checkpoint(tmp_path / "ckpts", 11, b)
    assert _state_diff(a.state_dict(), b.state_dict()) == []
    assert "WARNING" not in capsys.readouterr().err
    (tmp_path / "ckpts" / "format_version").write_text("1")
    checkpoint.restore_checkpoint(tmp_path / "ckpts", 11, b)
    assert "checkpoint format v1" in capsys.readouterr().err
    other = "adam" if optimizer == "rmsprop" else "rmsprop"
    with pytest.raises(ValueError, match="optimizer"):
        checkpoint.restore_checkpoint(
            tmp_path / "ckpts", 11, SlimTrainer(bev, **{**kw, "optimizer": other}))


def test_checkpoint_config_sanity(tmp_path):
    _, cfg = _cfgs()
    save_config(cfg, tmp_path / "config.yml")
    (tmp_path / "ckpts").mkdir()
    assert checkpoint.check_checkpoint_config_sanity(tmp_path / "ckpts", cfg)
    changed = cfg.deepcopy()
    changed.data.img_grid_size = (128, 128)
    with pytest.raises(ValueError, match="data.img_grid_size"):
        checkpoint.check_checkpoint_config_sanity(tmp_path / "ckpts", changed)


def test_slim_cli_trains_saves_and_exports(tmp_path, monkeypatch):
    from liso_tpu_torch.cli import slim_cli

    _no_tensorboard(monkeypatch)
    args = ["-c", "slim_liso", "--fast-test", "--device", "cpu",
            "--summary_dir", str(tmp_path), "-kv", *KV[0]]
    calls = {n: (trace.stats(n) or {"calls": 0})["calls"] for n in SLIM_SPANS}
    log_dir = slim_cli.main(args)
    ckpt = log_dir / "ckpts"
    assert checkpoint.latest_step(ckpt) == 3
    # each of the 3 steps opens the experiment's step and wait spans, the
    # train step's two and the three inside its loss_and_grads
    assert {n: trace.stats(n)["calls"] - calls[n] for n in SLIM_SPANS} == {
        n: 3 for n in SLIM_SPANS}
    state = torch.load(ckpt / "3" / checkpoint.STATE_FILE, weights_only=True)
    assert state["step"] == 3 and state["optimizer"]["name"] == "rmsprop"
    assert float(state["movavg"]["bias_counter"]) > 0
    out = slim_cli.main(args + ["--inference-only", "--load_checkpoint",
                                str(ckpt)])
    files = sorted((out / "preds").glob("*.npz"))
    assert [f.name for f in files] == [f"synth0_{t:04d}.npz" for t in range(4)]
    from liso_tpu_torch.models.slim import MovAvgState

    want = float(movavg_value(MovAvgState(**state["movavg"])))
    for f in files:  # the export ran from the checkpoint's state
        assert float(np.load(f)["static_threshold"]) == want
    with pytest.raises(SystemExit):
        slim_cli.main(args + ["--inference-only"])


def test_detect_anomaly_raises_before_the_update():
    """With detect_anomaly, a non-finite loss stops the step before the
    optimizer touches the state: the batch is re-run under autograd's
    anomaly mode and FloatingPointError names the step."""
    from liso_tpu_torch.data.sample import FlowSample, PointCloud

    tt = SlimTrainer(BevSetup((RANGE, RANGE), (32, 32)), num_iters=1,
                     detect_anomaly=True, device="cpu")
    g = torch.Generator().manual_seed(3)
    pts = (torch.rand(1, 512, 4, generator=g) - 0.5) * 36
    valid = torch.ones(1, 512, dtype=torch.bool)
    eye = torch.eye(4)[None]
    batch = FlowSample(PointCloud(pts, valid), PointCloud(pts + 0.3, valid),
                       eye, eye)
    forward = tt._forward_and_loss

    def nan_loss(*a, **kw):  # a loss of 0 * inf: NaN, and NaN gradients
        loss, *rest = forward(*a, **kw)
        return (loss * torch.tensor(float("inf")) * 0.0, *rest)

    tt._forward_and_loss = nan_loss
    before = {k: v.clone() for k, v in tt.nu.items()}
    with pytest.raises(FloatingPointError, match="SLIM train step 0"):
        tt.train_step(batch)
    assert tt.step == 0
    assert all(torch.equal(before[k], v) for k, v in tt.nu.items())
    assert all(bool(torch.isfinite(p).all()) for p in tt.params.values())


def test_config_is_the_ports_own_copy():
    """The port reads its own copy of the config (never liso_tpu/), and the
    copy holds what the JAX package's files hold."""
    from pathlib import Path

    from liso_tpu_torch.data import labels

    root = Path(__file__).resolve().parent.parent
    assert DEFAULT_CFG.resolve().parent == root / "liso_tpu_torch" / "config"
    assert Path(labels.__file__).resolve().parent.parent == root / "liso_tpu_torch"
    for name in ("liso_config.yml", "label_mappings.yml"):
        assert ((root / "liso_tpu_torch" / "config" / name).read_bytes()
                == (root / "liso_tpu" / "config" / name).read_bytes()), name


def test_experiment_refuses_cpu_fallback(monkeypatch, tmp_path):
    from liso_tpu_torch.cli import slim_cli
    from liso_tpu_torch.train.slim_experiment import slim_trainer_from_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slim_trainer_from_cfg(cfg, BevSetup((RANGE, RANGE), (32, 32)), 1)
    _no_tensorboard(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slim_cli.main(["-c", "slim_liso", "--fast-test", "--summary_dir",
                       str(tmp_path), "-kv", *KV[0]])


def test_load_slim_train_state_carries_adam():
    """An Adam state (mu, nu, count) carried across from flax trees lands
    in the port's moments under the port's names and layout."""
    from liso_tpu_torch.weights import flax_state_dict

    jt = JTrainer(JBev((RANGE, RANGE), (32, 32)), num_iters=1,
                  optimizer="adam")
    pts = jnp.zeros((1, 256, 4))
    valid = jnp.ones((1, 256), bool)
    v = random_variables(jt.model.init, pts, valid, pts, valid, seed=12)
    rng = np.random.RandomState(13)
    mu, nu = (jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), v["params"])
        for _ in range(2))
    tt = SlimTrainer(BevSetup((RANGE, RANGE), (32, 32)), num_iters=1,
                     optimizer="adam", device="cpu")
    movavg = {"importance": np.zeros(100_000, np.float32),
              "bias_counter": np.float32(0), "update_weight": np.float32(1e-6),
              "start_value": np.float32(0.5)}
    load_slim_train_state(tt, {"step": 7, "count": 7, "params": v["params"],
                               "batch_stats": v["batch_stats"], "mu": mu,
                               "nu": nu, "movavg": movavg})
    assert tt.step == tt.count == 7
    for name, tree in (("mu", mu), ("nu", nu)):
        want = flax_state_dict(tt.model, {"params": tree})
        got = getattr(tt, name)
        assert set(got) == set(want) and len(got) == len(tt.params)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    with pytest.raises(KeyError):
        load_slim_train_state(tt, {"step": 7, "params": v["params"],
                                   "batch_stats": v["batch_stats"], "nu": nu,
                                   "movavg": movavg})
