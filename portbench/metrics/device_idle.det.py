"""Share (%) of the traced window of the rounds loop's step with no operation on the card."""
from portbench import readers


def read(record):
    return readers.device_idle(record)
