"""Host ms per streaming step in the program's `stream.flow` span (serve.fused_streaming): the launches of the correlation and GRU loop, against `flow_ms.stream` on the device."""
from portbench import program_spans


def read(record):
    return program_spans.host_ms("stream.flow")
