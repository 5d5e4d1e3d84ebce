"""The SLIM train step's model FLOP/s as a share (%) of the fp32 peak."""
from portbench import readers


def read(record):
    return readers.mfu(record)
