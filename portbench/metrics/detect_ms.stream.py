"""Device ms per streaming step launched under the program's `stream.detect` span (serve.fused_streaming): CenterPoint on the pillar image, BoxLearner."""
from portbench import program_spans


def read(record):
    return program_spans.device_ms(record, "stream.detect")
