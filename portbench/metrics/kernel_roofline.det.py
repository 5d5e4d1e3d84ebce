"""Roofline share (%) of the detector step's hand-written kernels: K1 (scatter-max) and the fused scatter-max VJP."""
from portbench import readers


def read(record):
    return readers.kernel_roofline(record, ("K1", "K1_vjp"))
