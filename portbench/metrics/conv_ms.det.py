"""Device ms per step in the detector's convolutions, forward and backward (models/centerpoint.py, models/layers.py)."""
from portbench import readers


def read(record):
    return readers.conv_ms(record)
