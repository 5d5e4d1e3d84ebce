"""Device ms per streaming step in the flow stage's convolution kernels:
cuDNN's (implicit GEMMs and direct convolutions, and their NCHW <-> NHWC
layout transforms), found by name among the device events launched under
the program's `stream.flow` span, one by one or by a CUDA graph's replay
(`kernel_names`). The bias adds, elementwise kernels that PyTorch launches
after a convolution, are not in it."""
from portbench import kernel_names

KEYS = ("conv", "fprop", "implicit_gemm", "cudnn", "nchwToNhwc",
        "nhwcToNchw")


def read(record):
    found = kernel_names.events(record, "stream.flow", KEYS)
    if not found:
        return None
    return sum(e.dur for e in found) * 1e-6 / record.trace.steps * 1e3
