"""Share (%) of the train loader's recent batches that the consumer found missing from the queue when it asked (data/pipeline.Prefetcher: 100 x `data.queue_empty` / `data.batches` over the counters' rings, the last 256 batches taken with no profiler recording: the window's)."""
from portbench import program_spans


def read(record):
    trace = program_spans.tracer()
    ring = getattr(trace, "counter_ring", None)
    batches = sum(ring("data.batches")) if ring else 0
    if not batches:
        return None
    return 100.0 * sum(ring("data.queue_empty")) / batches
