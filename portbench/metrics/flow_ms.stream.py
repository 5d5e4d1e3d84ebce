"""Device ms per streaming step launched under the program's `stream.flow` span (serve.fused_streaming): the flow from the cached features: correlation (K2), the GRU iterations and the upsampling, SlimModel.flow_from_features."""
from portbench import program_spans


def read(record):
    return program_spans.device_ms(record, "stream.flow")
