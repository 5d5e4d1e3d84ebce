"""LiDAR odometry: point-to-point ICP (KISS-ICP equivalent for the ETL).

Behavioral reference: the reference consumes kiss-icp (external C++ pybind,
datasets/kitti/create_kitti_raw.py:39-177) for training-path-independent
offline odometry. Here the same role is filled by the port's copy of
native/icp.cpp (liso_tpu_torch/native/icp.cpp: voxel-hash point-to-point
ICP, built with g++ at first use into liso_tpu_torch/native/_build/ and
loaded via ctypes), with a scipy-cKDTree path where no C++ compiler is
found — constant-velocity initialisation, voxel downsampling, and
scan-to-local-map registration like KISS-ICP's core loop.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from liso_tpu_torch.utils.atomic import publish

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "icp.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_LIB = None


def _build_native():
    """The shared library of NATIVE_SRC, built with g++ when missing (its
    name holds a hash of the source and the flags); None without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    h = hashlib.sha256(NATIVE_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    so = NATIVE_SRC.parent / "_build" / f"libliso_native-{h.hexdigest()[:16]}.so"
    if not so.exists():
        so.parent.mkdir(exist_ok=True)
        # atomic: concurrent builds race harmlessly
        publish(so, lambda tmp: subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
            check=True, capture_output=True, timeout=300))
    return so


def _load_native():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _build_native()
    if so is None:
        _LIB = False
        return False
    lib = ctypes.CDLL(str(so))
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.icp_register.restype = ctypes.c_int
    lib.icp_register.argtypes = [
        dptr, ctypes.c_int, dptr, ctypes.c_int, dptr,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, dptr,
    ]
    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [
        dptr, ctypes.c_int, ctypes.c_double, dptr, ctypes.c_int,
    ]
    lib.nn1_query.restype = None
    lib.nn1_query.argtypes = [
        dptr, ctypes.c_int, dptr, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int64), dptr,
    ]
    _LIB = lib
    return lib


def _as_c(arr):
    a = np.ascontiguousarray(arr, np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def voxel_downsample(pts: np.ndarray, voxel: float) -> np.ndarray:
    lib = _load_native()
    if lib:
        a, p = _as_c(pts[:, :3])
        out = np.empty_like(a)
        m = lib.voxel_downsample(p, len(a), voxel,
                                 out.ctypes.data_as(
                                     ctypes.POINTER(ctypes.c_double)), len(a))
        return out[:m]
    # numpy fallback: first point per voxel
    keys = np.floor(pts[:, :3] / voxel).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(first), :3].astype(np.float64)


def icp_register(
    source: np.ndarray,
    target: np.ndarray,
    T_init: np.ndarray,
    voxel: float = 1.0,
    max_corr_dist: float = 1.0,
    max_iters: int = 30,
) -> np.ndarray:
    """Refine T_init (source -> target frame). Returns 4x4."""
    lib = _load_native()
    if lib:
        s, sp = _as_c(source[:, :3])
        t, tp = _as_c(target[:, :3])
        Ti, Tip = _as_c(T_init.reshape(-1))
        out = np.empty(16, np.float64)
        lib.icp_register(
            sp, len(s), tp, len(t), Tip, voxel, max_corr_dist, max_iters,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out.reshape(4, 4)
    return _icp_numpy(source[:, :3], target[:, :3], T_init, max_corr_dist,
                      max_iters)


def _icp_numpy(src, tgt, T_init, max_corr_dist, max_iters):
    from scipy.spatial import cKDTree

    tree = cKDTree(tgt)
    T = np.array(T_init, np.float64)
    for _ in range(max_iters):
        q = src @ T[:3, :3].T + T[:3, 3]
        d, j = tree.query(q, k=1, distance_upper_bound=max_corr_dist)
        ok = np.isfinite(d)
        if ok.sum() < 10:
            break
        a = q[ok]
        b = tgt[j[ok]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        d3 = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d3]) @ U.T
        t = cb - R @ ca
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        if np.linalg.norm(t) < 1e-6 and abs(np.trace(R) - 3) < 1e-9:
            break
    return T


def icp_odometry(
    scans: List[np.ndarray],
    voxel: float = 1.0,
    max_corr_dist: float = 1.5,
) -> List[np.ndarray]:
    """Sequential scan-to-previous-scan odometry with constant-velocity
    initialisation. Returns [T] world_T_sensor poses (first = identity)."""
    poses = [np.eye(4)]
    prev_delta = np.eye(4)
    prev_ds: Optional[np.ndarray] = None
    for i, scan in enumerate(scans):
        ds = voxel_downsample(scan, voxel)
        if i == 0:
            prev_ds = ds
            continue
        delta = icp_register(
            ds, prev_ds, prev_delta, voxel=voxel,
            max_corr_dist=max_corr_dist,
        )
        poses.append(poses[-1] @ delta)
        prev_delta = delta
        prev_ds = ds
    return poses
