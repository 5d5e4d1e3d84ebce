"""Device ms per streaming step launched under the program's `stream.encode` span (serve.fused_streaming): RAFT's encoder on the new frame, SlimModel.encode_frame."""
from portbench import program_spans


def read(record):
    return program_spans.device_ms(record, "stream.encode")
