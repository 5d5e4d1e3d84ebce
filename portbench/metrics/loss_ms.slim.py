"""Device ms per SLIM train step launched under the program's `slim.loss` span (SlimTrainer: every iteration's decode with its weighted Kabsch, the two batched 1-NN searches with K6, the loss terms, the threshold update with K3)."""
from portbench import program_spans


def read(record):
    return program_spans.device_ms(record, "slim.loss")
