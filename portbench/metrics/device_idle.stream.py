"""Share (%) of the traced window of streaming steps with no operation on the card."""
from portbench import readers


def read(record):
    return readers.device_idle(record)
