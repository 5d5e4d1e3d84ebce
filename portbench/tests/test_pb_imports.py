"""Nothing the benchmark loads is the JAX stack or the JAX package (top
names compared whole), and the plain reference loads nothing of the
program."""
import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT}).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    mods = _loaded("import portbench.run, portbench.harness, "
                   "portbench.entries.stream, portbench.entries.round_step, "
                   "portbench.readings\n"
                   "import liso_tpu_torch.serve, liso_tpu_torch.train.liso_loop")
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)
    assert "liso_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.models, "
                   "portbench.reference.detector_step, "
                   "portbench.reference.compare")
    assert "liso_tpu_torch" not in mods
    assert not mods & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "liso_tpu_torch_x", sys)
    assert "liso_tpu" not in harness.forbidden_modules() or \
        "liso_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_run_refuses_without_the_card(tmp_path):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "stream_b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env={"PATH": "/usr/bin:/bin",
                                       "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
