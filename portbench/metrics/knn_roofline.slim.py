"""Roofline share (%) of K6, the banded exact 1-NN (liso_tpu_torch/kernels/knn_banded.cu), in the SLIM train step: its kernels found by name in the traced window, the pairs its calls' queries need counted by `slim_costs` from an exact search of the benchmark's own."""
from portbench import slim_costs


def read(record):
    return slim_costs.roofline(record, "K6")
