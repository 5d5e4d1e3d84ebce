"""Host ms per rounds-loop step in the program's `det.loss` span: the train-mode forward and the loss terms (DetectorTrainer.train_step)."""
from portbench import program_spans


def read(record):
    return program_spans.host_ms("det.loss")
