"""Whole-file publishes of the port (liso_tpu_torch.utils.atomic), on the
CPU: a file that one process publishes and another reads, or that a later
run resumes from, appears whole or not at all.

- The replica digest (`LisoSelfTraining._assert_replicas_in_sync`): a
  reader that polls the rendezvous directory while both workers publish
  only ever sees 64 hex characters, and both workers' checks pass at poll
  0, over many fresh steps.
- Checkpoints (`utils/checkpoint.save_checkpoint`): a save that dies inside
  `torch.save`, after half its bytes, leaves the previous step (and an
  earlier save of the same step) loadable bitwise, through
  `restore_checkpoint`, `SlimExperiment.maybe_restore` and
  `LisoSelfTraining.restore`; a leftover of a killed save is ignored.
- The flow export (`SlimExperiment.export_flow`): an npz write cut off
  after part of the file leaves no file of that sample, so a rerun with
  skip_existing writes it, and every npz of the directory loads.
- What is published is unchanged: the digest is the parameters' sha256,
  checkpoints are `<step>/state.pt` with format_version 2, an export holds
  export_sample's arrays under `<sample_id>.npz`.
"""
import copy
import hashlib
import io
import sys
import threading

import numpy as np
import pytest
import torch

from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.synthetic import SyntheticDataset
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.train import slim_experiment
from liso_tpu_torch.train.slim_experiment import SlimExperiment, export_sample
from liso_tpu_torch.train.slim_train import SlimTrainer
from liso_tpu_torch.utils import checkpoint
from liso_tpu_torch.utils.config import parse_config
from test_torch_liso_rounds import _in_both, _sync_loops, assert_same_state

torch.set_num_threads(1)
READER_TRIALS, SYNC_TRIALS = 30, 120
GRID, RANGE, N_MAX = 32, 40.0, 1024
KV = [["SLIM", "model", "num_iters", "1"]]


# ---------------------------------------------------------------------------
# The replica digest
# ---------------------------------------------------------------------------
def _params_sha256(trainer):
    h = hashlib.sha256()
    for name in sorted(trainer.params):
        h.update(np.ascontiguousarray(
            trainer.params[name].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def sync_loops(tmp_path_factory):
    return _sync_loops(tmp_path_factory.mktemp("sync"))


def test_a_polling_reader_sees_whole_digests(sync_loops):
    """A third thread polls each step's rendezvous directory at poll 0
    while both workers publish (thread switches every 10 us, so it runs
    between a write's syscalls): every digest file it finds holds the whole
    digest. Written in place, it found empty or partial ones."""
    log_dir = sync_loops[0].log_dir
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    seen, torn, failed = 0, [], []
    try:
        for k in range(READER_TRIALS):
            out = log_dir / f"param_sync_step_{10_000 + k}"
            stop = threading.Event()

            def poll():
                nonlocal seen
                while not stop.is_set():
                    for f in (out / "digest_worker0", out / "digest_worker1"):
                        try:
                            text = f.read_text()
                        except FileNotFoundError:
                            continue
                        seen += 1
                        if len(text) != 64 or set(text) - set("0123456789abcdef"):
                            torn.append((f.name, text))

            reader = threading.Thread(target=poll)
            reader.start()
            try:
                errors = _in_both(sync_loops, 10_000 + k, poll_s=0,
                                  timeout_s=10)
            finally:
                stop.set()
                reader.join(timeout=30)
            assert not reader.is_alive()
            if errors != [None, None]:
                failed.append((k, errors))
    finally:
        sys.setswitchinterval(old)
    assert not torn, (f"{len(torn)} torn reads of {seen}, e.g. {torn[:3]}; "
                      f"{len(failed)} of {READER_TRIALS} checks failed")
    assert not failed, failed[:3]
    assert seen > 0


def test_replicas_in_sync_pass_at_poll_0(sync_loops):
    """test_torch_liso_rounds' check, repeated over fresh steps at poll 0,
    where each worker reads its peer's file as soon as it appears."""
    failed = []
    for k in range(SYNC_TRIALS):
        errors = _in_both(sync_loops, 20_000 + k, poll_s=0, timeout_s=10)
        if errors != [None, None]:
            failed.append((k, errors))
    assert not failed, f"{len(failed)} of {SYNC_TRIALS} trials: {failed[:3]}"


def test_published_digest_is_unchanged(sync_loops):
    """The rendezvous directory holds the two digest files and nothing
    else, each the sha256 of the parameters by sorted name."""
    assert _in_both(sync_loops, 30_000, poll_s=0, timeout_s=10) == [None, None]
    out = sync_loops[0].log_dir / "param_sync_step_30000"
    assert sorted(p.name for p in out.iterdir()) == ["digest_worker0",
                                                     "digest_worker1"]
    for w in (0, 1):
        assert ((out / f"digest_worker{w}").read_text()
                == _params_sha256(sync_loops[w].trainer))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
class Killed(OSError):
    """What the patched writers raise after half a file."""


def _half_torch_save(monkeypatch):
    """torch.save as seen by utils/checkpoint: half the file, then raise."""
    real = torch.save

    def half(obj, f):
        buf = io.BytesIO()
        real(obj, buf)
        data = buf.getvalue()
        with open(f, "wb") as out:
            out.write(data[: len(data) // 2])
        raise Killed("save cut off")

    monkeypatch.setattr(checkpoint.torch, "save", half)


def _perturb(trainer):
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)


def _save_then_fail(monkeypatch, save, trainer, steps):
    """`save(steps[0])` whole, then perturb `trainer` and have `save` die
    inside torch.save at each of `steps` (a same-step resave first). The
    whole save's state."""
    save(steps[0])
    want = copy.deepcopy(trainer.state_dict())
    _perturb(trainer)
    with monkeypatch.context() as m:
        _half_torch_save(m)
        for step in steps:
            with pytest.raises(Killed):
                save(step)
    return want


def _slim_trainer(seed):
    return SlimTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)), seed=seed,
                       num_iters=1, device="cpu")


def _experiment(tmp_path):
    cfg = parse_config(str(DEFAULT_CFG), ["slim_liso"], KV)
    return SlimExperiment(cfg, BevSetup((RANGE, RANGE), (GRID, GRID)),
                          _dataset(), None, tmp_path / "exp", device="cpu")


def _dataset():
    cfg = DataCfg(bev=BevSetup((RANGE, RANGE), (GRID, GRID)), n_max=N_MAX,
                  m_max=4 * N_MAX, use_skip_frames="never")
    return SyntheticDataset(cfg, n_frames=3, seed=0, n_points=800)


def test_killed_save_keeps_the_previous_step(tmp_path, monkeypatch):
    """A resave of step 4 and a save of step 8 die inside torch.save: step
    4 stays the newest, loads bitwise, and the directory holds only what a
    whole save leaves. A killed process's leftover, a half-written state
    under a temporary name, is ignored."""
    ckpts = tmp_path / "ckpts"
    a = _slim_trainer(1)
    want = _save_then_fail(
        monkeypatch, lambda s: checkpoint.save_checkpoint(ckpts, s, a), a,
        [4, 8])
    assert checkpoint.latest_step(ckpts) == 4
    assert sorted(p.name for p in ckpts.iterdir()) == ["4", "format_version"]
    assert [p.name for p in (ckpts / "4").iterdir()] == ["state.pt"]
    assert (ckpts / "format_version").read_text() == "2"
    leftover = ckpts / ".9.99999999.tmp"
    leftover.mkdir()
    (leftover / "state.pt").write_bytes(
        (ckpts / "4" / "state.pt").read_bytes()[:1000])
    assert checkpoint.latest_step(ckpts) == 4
    b = _slim_trainer(2)
    checkpoint.restore_checkpoint(ckpts, 4, b)
    assert_same_state(b.state_dict(), want)


def test_slim_experiment_resumes_from_the_previous_step(tmp_path, monkeypatch):
    """As SlimExperiment.run saves."""
    exp = _experiment(tmp_path)
    ckpts = exp.log_dir / "ckpts"
    want = _save_then_fail(
        monkeypatch,
        lambda s: checkpoint.save_checkpoint(ckpts, s, exp.trainer),
        exp.trainer, [3, 6])
    exp.maybe_restore()
    assert_same_state(exp.trainer.state_dict(), want)


def test_rounds_loop_resumes_from_the_previous_step(sync_loops, monkeypatch):
    """As LisoSelfTraining.run saves (`save`) and liso_cli resumes."""
    loop = sync_loops[0]
    want = _save_then_fail(monkeypatch, loop.save, loop.trainer, [3, 6])
    try:
        assert loop.restore(loop.log_dir / "ckpts") == 3
        assert_same_state(loop.trainer.state_dict(), want)
    finally:  # the digest tests share the loops: keep them equal
        sync_loops[1].trainer.load_state_dict(loop.trainer.state_dict())


# ---------------------------------------------------------------------------
# Flow export
# ---------------------------------------------------------------------------
def test_killed_export_is_rewritten_by_a_rerun(tmp_path, monkeypatch):
    """The second sample's npz write dies after half the file: the first
    sample's npz is whole, the second has no file, and a rerun with
    skip_existing writes the second and third; every npz loads and holds
    export_sample's arrays."""
    exp, ds = _experiment(tmp_path), _dataset()
    out = tmp_path / "preds"
    real, calls = np.savez_compressed, []

    def cut_second(file, **arrays):
        calls.append(1)
        if len(calls) != 2:
            return real(file, **arrays)
        buf = io.BytesIO()
        real(buf, **arrays)
        data = buf.getvalue()[: buf.tell() // 2]
        if hasattr(file, "write"):
            file.write(data)
        else:  # a path: savez's own suffix rule
            name = str(file) if str(file).endswith(".npz") else f"{file}.npz"
            with open(name, "wb") as f:
                f.write(data)
        raise Killed("export cut off")

    with monkeypatch.context() as m:
        m.setattr(slim_experiment.np, "savez_compressed", cut_second)
        with pytest.raises(Killed):
            exp.export_flow(ds, out)
    ids = [ds[i].sample_id for i in range(len(ds))]
    assert sorted(p.name for p in out.iterdir()) == [f"{ids[0]}.npz"]
    first = (out / f"{ids[0]}.npz").read_bytes()
    assert exp.export_flow(ds, out) == 2
    assert (out / f"{ids[0]}.npz").read_bytes() == first
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{i}.npz" for i in ids)
    for idx, sid in enumerate(ids):
        got = np.load(out / f"{sid}.npz")
        want = export_sample(exp.trainer, ds, idx)
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
