"""Meters and the ``metrics.jsonl`` stream (port of
``pcrlv2_tpu/utils/meters.py``; reference ``utils.py:117-137``)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class AverageMeter:
    """Running value and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def metrics_path(output_dir: str, rank: int = 0, name: str = "metrics.jsonl") -> str:
    """Rank ``rank``'s metrics file in a (possibly shared) output directory:
    ``name`` on rank 0, which every tool reads, ``metrics.rank{i}.jsonl`` on
    the others, so ranks never interleave lines in one stream."""
    if rank:
        base, ext = os.path.splitext(name)
        name = f"{base}.rank{rank}{ext}"
    return os.path.join(output_dir, name)


class MetricLogger:
    """Console plus an optional JSONL stream, one JSON object per report."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step_info: Dict, console: bool = True):
        rec = dict(step_info, ts=time.time())
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if console:
            parts = [f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in step_info.items()]
            print("\t".join(parts))
            sys.stdout.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
