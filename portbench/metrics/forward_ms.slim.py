"""Device ms per SLIM train step launched under the program's `slim.forward` span (SlimTrainer: SlimModel in both directions: the pillar encoders, RAFT's encoders, the GRU iterations with K2, the upsampling)."""
from portbench import program_spans


def read(record):
    return program_spans.device_ms(record, "slim.forward")
