"""Device ms per streaming step in convolutions (models/raft.py, models/centerpoint.py)."""
from portbench import readers


def read(record):
    return readers.conv_ms(record)
