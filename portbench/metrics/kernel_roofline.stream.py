"""Roofline share (%) of the streaming step's hand-written kernels: K1 (scatter-max) and K2 (correlation window)."""
from portbench import readers


def read(record):
    return readers.kernel_roofline(record, ("K1", "K2"))
