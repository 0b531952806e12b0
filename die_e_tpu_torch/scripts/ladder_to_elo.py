"""Fold strength-ladder rows into the Elo match pool; the port of
``scripts/ladder_to_elo.py``.

The ladder's rungs are played with the tournament's arena settings, so a
rung is an Elo match: this appends the ``strength_ladder`` rows of
``--ladder`` to ``--out`` as ``elo_match`` records
(``arena/elo.py::ladder_rows_to_match_records``), skipping pairs already
recorded there at the same games and sims; ``elo_tournament`` then pools
them into the fit.  Host only: no device work.

Usage:

    python -m die_e_tpu_torch.scripts.ladder_to_elo [--ladder runs/bg_full/ladder.jsonl]
        [--out runs/bg_full/elo_matches.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from die_e_tpu_torch.arena.elo import ladder_rows_to_match_records


def read_jsonl(p) -> list:
    path = Path(p)
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ladder", default="runs/bg_full/ladder.jsonl")
    ap.add_argument("--out", default="runs/bg_full/elo_matches.jsonl")
    args = ap.parse_args(argv)

    skipped: list = []
    new = ladder_rows_to_match_records(
        read_jsonl(args.ladder), read_jsonl(args.out), skipped=skipped)
    with open(args.out, "a") as f:
        for rec in new:
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    for row in skipped:
        print(f"skipped (already recorded): {json.dumps(row)}", file=sys.stderr)
    print(f"appended {len(new)} match records to {args.out} "
          f"({len(skipped)} duplicates skipped)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
