"""Validation loop (port of liso_tpu/eval/run_val.py, so far only
`mined_db_predictor`, which mining's sequence renderings read; `run_val`
and the metric banks come with the rounds loop, ROADMAP section A item 3).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def mined_db_predictor(mined_db: Dict[str, dict]):
    """eval_ours.py:281-291: a mined-box DB dict acts as the predictor."""

    def predict(batch):
        b = len(batch["sample_id"])
        k_max = max(
            [len(mined_db.get(sid, {"track_id": []})["track_id"]) for sid in
             batch["sample_id"]] + [1]
        )
        out = {
            "pos": np.zeros((b, k_max, 3), np.float32),
            "dims": np.zeros((b, k_max, 3), np.float32),
            "rot": np.zeros((b, k_max, 1), np.float32),
            "probs": np.zeros((b, k_max, 1), np.float32),
            "velo": np.zeros((b, k_max, 1), np.float32),
            "valid": np.zeros((b, k_max), bool),
        }
        for i, sid in enumerate(batch["sample_id"]):
            entry = mined_db.get(sid)
            if entry is None:
                continue
            raw = entry["raw_box"]
            k = len(raw["pos"])
            for key in ("pos", "dims", "rot", "probs", "velo"):
                if key in raw:
                    out[key][i, :k] = raw[key]
            out["valid"][i, :k] = True
        return out

    return predict
