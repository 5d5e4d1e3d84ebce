"""Host ms per rounds-loop step in the program's `det.optimizer` span: the schedule's rate, AdamW's per-leaf update and the gradient's global norm (DetectorTrainer._update)."""
from portbench import program_spans


def read(record):
    return program_spans.host_ms("det.optimizer")
