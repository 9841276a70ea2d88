"""Structured per-frame metrics (JSONL).

A copy of ``visual_odom_tpu/utils/metrics.py``: one JSON object per frame,
the ``t`` key (seconds since the logger opened) first, ``None`` values
dropped and anything with ``.item()`` (numpy or torch scalars) written as
its Python value. It replaces the reference's unstructured prints (feature
counts src/feature.cpp:251, scale src/utils.cpp:76, inliers
src/visualOdometry.cpp:191, FPS src/main.cpp:212-213).
"""

from __future__ import annotations

import json
import time
from typing import Any


class MetricsLogger:
    def __init__(self, path: str):
        self._f = open(path, "w")
        self._t0 = time.time()

    def log(self, record: dict[str, Any]) -> None:
        rec = {"t": round(time.time() - self._t0, 4)}
        for k, v in record.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
