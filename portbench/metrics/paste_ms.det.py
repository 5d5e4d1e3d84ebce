"""Host ms per step in LisoSelfTraining._prepare_batch: the copy-paste augmentation and the pinned copy to the card."""


def read(record):
    return record.stage_ms_per_step("prepare")
