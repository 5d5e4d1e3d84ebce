"""Roofline share (%) of K5, the correlation window's backward (liso_tpu_torch/kernels/corr_window_bwd.cu), in the SLIM train step: its kernels found by name in the traced window (autograd's thread launches them), each call's bytes and operations counted by `slim_costs` from its inputs and outputs."""
from portbench import slim_costs


def read(record):
    return slim_costs.roofline(record, "K5")
