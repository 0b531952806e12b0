"""Structured metrics and progress reporting.

The port's own copy of ``die_e_tpu/core/metrics.py``: the same JSONL event
records.

Replaces the reference's indicatif progress bars + println observability
(reference src/alphazero/alpha_parallel.rs:22-39, src/versus.rs:162-209) with
structured metric emission — loss, steps/s, sims/s, gate winrate — which the
reference lacks entirely (SURVEY.md section 5: "no loss logging, no
TensorBoard").  Metrics go to stderr as human-readable lines and optionally to
a JSONL file for the bench harness.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional


class Metrics:
    def __init__(self, jsonl_path: Optional[str] = None, quiet: bool = False):
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        self.quiet = quiet
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        rec = {"t": round(time.perf_counter() - self._t0, 3), "event": event}
        rec.update(fields)
        if not self.quiet:
            kv = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{rec['t']:9.2f}s] {event:24s} {kv}", file=sys.stderr)
        if self.jsonl_path:
            with self.jsonl_path.open("a") as f:
                f.write(json.dumps(rec) + "\n")


class Timer:
    """Wall-clock timer for throughput metrics; the timed work must end in
    a host read of its result (or a device synchronise)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
