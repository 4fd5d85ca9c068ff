"""Run-level metrics sink: append-only JSONL (and optional CSV mirror).

Port of ``f1tenth_gym_tpu/utils/metrics.py``: the port's own copy, so that
it never imports the JAX package.

    logger = MetricsLogger("run/metrics.jsonl")
    logger.log(step=it, loss=0.3, reward=-0.1)   # one JSON object per line
    rows = read_jsonl("run/metrics.jsonl")
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with an optional CSV mirror.

    Values are coerced to plain Python scalars (0-d tensors and numpy
    scalars included); every record gets a wall-clock ``time`` field.
    Files are flushed per record so a killed run keeps everything logged
    so far.
    """

    def __init__(self, path: str, csv_path: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._csv = None
        self._csv_fields: Optional[List[str]] = None
        if csv_path:
            self._csv = open(csv_path, "a", buffering=1)

    @staticmethod
    def _scalar(v: Any) -> Any:
        if hasattr(v, "item"):
            try:
                return v.item()
            except (TypeError, ValueError, RuntimeError):
                pass
        return v

    def log(self, **values: Any) -> Dict[str, Any]:
        rec = {k: self._scalar(v) for k, v in values.items()}
        rec.setdefault("time", time.time())
        self._f.write(json.dumps(rec) + "\n")
        if self._csv is not None:
            if self._csv_fields is None:
                self._csv_fields = list(rec.keys())
                self._csv.write(",".join(self._csv_fields) + "\n")
            self._csv.write(
                ",".join(str(rec.get(k, "")) for k in self._csv_fields) + "\n")
        return rec

    def close(self) -> None:
        self._f.close()
        if self._csv is not None:
            self._csv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL metrics file back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
