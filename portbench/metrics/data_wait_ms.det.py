"""Host ms per step waiting on the train loader (data/pipeline.Prefetcher, data/dataset.py)."""


def read(record):
    return record.stage_ms_per_step("wait")
