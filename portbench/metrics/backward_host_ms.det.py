"""Host ms per rounds-loop step in the program's `det.backward` span: total.backward() (DetectorTrainer._update)."""
from portbench import program_spans


def read(record):
    return program_spans.host_ms("det.backward")
