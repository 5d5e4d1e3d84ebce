"""Share (%) of the traced window of the SLIM train step with no operation on the card."""
from portbench import readers


def read(record):
    return readers.device_idle(record)
