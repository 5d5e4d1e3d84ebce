"""Build and load the hand-written CUDA kernels at first use.

Each `*.cu` source in this directory is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface and loaded with
ctypes. A library's file name carries a hash of its source, of every
`*.cuh` header here and of the flags, so an edited source or header is
rebuilt and a stale build is never loaded. Builds go to
`_build/` beside the sources (listed in .gitignore). Nothing is compiled or
loaded when this module is imported: the CPU path never needs `nvcc`.

Every C entry point takes raw device pointers and the CUDA stream as
integers, launches on that stream without synchronising, and returns the
`cudaError_t` of the launch, which `check` turns into an exception.

Every wrapper (`ops/`, `models/layers.bn_relu_eval`, serve's flow stage)
asks `use_plain` whether to run its plain PyTorch version in place of the
kernel: for CPU tensors, inside `plain_versions()`, or for an `ops/`
wrapper's own `plain=True`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each source's entry point: (function name, argtypes)
SOURCES = {
    "grid_scatter_max": (
        "grid_scatter_max_occ",
        # feats, cells, grid, occ, B, N, C, num_cells, is_bf16, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "corr_window_fwd": (
        "corr_window_fwd",
        # f0, f1cat, coords, out, B, HW, C, M, L, level_meta, scale, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P],
    ),
    "scatter_max_vjp": (
        "scatter_max_vjp",
        # feats, cells, grid, g_grid, out, B, N, C, num_cells, is_bf16, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "grid_gather": (
        "grid_gather",
        # grid, cells, out, B, N, C, num_cells, is_bf16, stream
        [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "grid_reduce_add_c1": (
        "grid_reduce_add_c1",
        # vals, bins, out, rows, N, num_bins, stream
        [_P, _P, _P, _I, _I, _I, _P],
    ),
    "corr_window_bwd": (
        "corr_window_bwd",
        # f0, f1cat, coords, g, df0, df1, B, HW, C, M, L, level_meta, scale,
        # stream
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _P],
    ),
    "knn_banded": (
        "knn_banded",
        # q, q_valid, refs, ranges, suf_min, pre_max, dist, index, visited,
        # B, Nq, Nr_pad, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "grid_reduce_add": (
        "grid_reduce_add",
        # g, cells, out, B, N, C, num_cells, is_bf16, stream
        [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "bn_relu_eval": (
        "bn_relu_eval",
        # x, mean, scale, weight, bias, out, planes, C, inner, in_bf16,
        # out_bf16, stream
        [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P],
    ),
}

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that its path went through it.
launches = {fn_name: 0 for fn_name, _ in SOURCES.values()}

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_plain_depth = 0


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """While open (nested or not), every wrapper runs its plain PyTorch
    version, on the card too; `on=False` opens nothing. The depth is one
    for the process, not per thread: autograd's backward thread sees the
    scope, and so do the loader's. A wrapper asks when it runs, so a
    backward inside a scope runs plain even where its forward did not."""
    global _plain_depth
    if not on:
        yield
        return
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_plain(t: torch.Tensor, plain: bool = False) -> bool:
    """Whether a wrapper given `t` runs its plain version: `plain`, an open
    `plain_versions()` scope, or a CPU tensor."""
    return plain or _plain_depth > 0 or t.device.type == "cpu"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((_DIR / f"{name}.cu").read_bytes())
    for header in sorted(_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> float:
    """Compile every source in `names` (default: all) that has no current
    build, one `nvcc` per source, all started together. Returns the
    seconds taken. Raises with the compiler's output if any build fails.
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside it as `<lib>.ptxas.txt`."""
    t0 = time.perf_counter()
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_DIR / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """What ptxas printed for the current build of `name`."""
    return _lib_path(name).with_suffix(".ptxas.txt").read_text()


def function(name: str):
    """The C entry point of source `name`, building and loading it first
    if needed; typed once and kept, so a launch pays one dict lookup."""
    fn = _functions.get(name)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = SOURCES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name], _functions[name] = lib, fn
    return fn


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device` as the raw `cudaStream_t`
    an entry point takes, read without building the `torch.cuda.Stream`
    object that `torch.cuda.current_stream(device).cuda_stream` builds (and
    enters the device for) on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
