"""The streaming step's model FLOP/s as a share (%) of the bf16 peak."""
from portbench import readers


def read(record):
    return readers.mfu(record)
