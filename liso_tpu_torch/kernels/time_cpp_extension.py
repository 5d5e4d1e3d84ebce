"""Time a build of the kernel sources through torch.utils.cpp_extension.

    python3 -m liso_tpu_torch.kernels.time_cpp_extension

The port builds its kernels with `nvcc` into shared libraries with a plain C
interface, loaded with ctypes (`kernels.build`). This script builds the same
`*.cu` sources the other way, as one extension through
`torch.utils.cpp_extension.load`, with a pybind11 binding file that
includes `torch/extension.h`, into a fresh directory under `_build/`. It
prints the seconds of that build as one JSON line and writes it to
`chiprun_out/cpp_extension_build.json`, so that the two routes can be
compared on the same machine (`chip_smoke.py`'s `build` line times the
ctypes route).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

from liso_tpu_torch import kernels

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

BINDING = """
#include <torch/extension.h>
extern "C" int grid_scatter_max_occ(const void*, const void*, void*, void*,
                                    int, int, int, int, int, void*);
extern "C" int corr_window_fwd(const void*, const void*, const void*, void*,
                               int, int, int, int, int, const int*, float,
                               void*);
PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("grid_scatter_max_occ",
        [](int64_t f, int64_t ids, int64_t g, int64_t o, int b, int n, int c,
           int nc, int bf16, int64_t stream) {
          return grid_scatter_max_occ((const void*)f, (const void*)ids,
                                      (void*)g, (void*)o, b, n, c, nc, bf16,
                                      (void*)stream);
        });
  m.def("corr_window_fwd",
        [](int64_t f0, int64_t f1, int64_t xy, int64_t out, int b, int hw,
           int c, int m, int nl, std::vector<int> meta, float scale,
           int64_t stream) {
          return corr_window_fwd((const void*)f0, (const void*)f1,
                                 (const void*)xy, (void*)out, b, hw, c, m, nl,
                                 meta.data(), scale, (void*)stream);
        });
}
"""


def main() -> int:
    import torch
    from torch.utils import cpp_extension

    build_dir = kernels.BUILD_DIR / "cpp_extension"
    if build_dir.exists():
        shutil.rmtree(build_dir)  # time a build from nothing
    build_dir.mkdir(parents=True)
    (build_dir / "bind.cpp").write_text(BINDING)
    sources = [str(build_dir / "bind.cpp")] + [
        str(HERE / f"{n}.cu") for n in kernels.SOURCES
    ]
    # the same target as kernels.NVCC_FLAGS; load() defines the four
    # __CUDA_NO_*__ macros by default, undone here so that the sources
    # compile with the same headers as under kernels.build
    cuda_flags = ["-gencode=arch=compute_90a,code=sm_90a", "-O3"] + [
        f"-U__CUDA_NO_{n}__"
        for n in ("HALF_OPERATORS", "HALF_CONVERSIONS",
                  "BFLOAT16_CONVERSIONS", "HALF2_OPERATORS")
    ]
    t0 = time.perf_counter()
    ext = cpp_extension.load(
        name="liso_kernels_ext", sources=sources,
        extra_cuda_cflags=cuda_flags, build_directory=str(build_dir),
        verbose=False,
    )
    seconds = time.perf_counter() - t0
    assert hasattr(ext, "grid_scatter_max_occ") and hasattr(ext, "corr_window_fwd")
    result = {
        "route": "torch.utils.cpp_extension.load",
        "sources": [os.path.relpath(s, ROOT) for s in sources[1:]]
        + ["binding file with torch/extension.h"],
        "seconds": seconds,
        "cpu_count": os.cpu_count(),
        "max_jobs": os.environ.get("MAX_JOBS"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "cpp_extension_build.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
