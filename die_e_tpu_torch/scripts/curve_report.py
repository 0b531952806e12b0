"""Summarize a learn run's metrics.jsonl into a learning-curve table; the
port's own copy of the framework-free ``scripts/curve_report.py``.

The learn loop (``train/learn.py``) emits structured events
(``core/metrics.py``) to ``--metrics-jsonl``, across resumes; this folds
them into one row per learn iteration: final-epoch loss, self-play
throughput, gate result, as markdown or JSON lines.  Host only.

Usage:

    python -m die_e_tpu_torch.scripts.curve_report [--metrics runs/bg_full/metrics.jsonl]
        [--format md|jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load_events(path: str):
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    # torn line (a kill mid-append)
                    continue
    return events


def summarize(events):
    """One dict per learn iteration, keyed fields from its events."""
    iters: dict[int, dict] = defaultdict(dict)
    # gate events carry no learn_iter: attribute each to the most recent
    # model_saved iteration (the learn loop gates right after saving,
    # train/learn.py — mirrors alpha_parallel.rs:85-96 ordering).
    last_saved = None
    # restarts replay an iteration's self_play events: dedupe by
    # (learn_iter, sp_iter), keeping the last occurrence (the one whose
    # fragments actually fed training).
    sp_events: dict[tuple, dict] = {}
    for ev in events:
        kind = ev.get("event")
        it = ev.get("learn_iter")
        if kind == "self_play":
            sp_events[(it, ev.get("sp_iter"))] = ev
        elif kind == "train_epoch":
            row = iters[it]
            row.setdefault("loss_first", ev["loss"])
            row["loss"] = ev["loss"]
            row["policy_loss"] = ev["policy_loss"]
            row["value_loss"] = ev["value_loss"]
        elif kind == "model_saved":
            last_saved = it
        elif kind == "gate" and last_saved is not None:
            row = iters[last_saved]
            row["gate_winrate"] = ev.get("winrate")
            row["gate_result"] = ev.get("result")
    ent: dict[int, list] = defaultdict(list)
    for (it, _), ev in sp_events.items():
        row = iters[it]
        row["sp_fragments"] = row.get("sp_fragments", 0) + ev["fragments"]
        row["sp_sims_per_s"] = ev["sims_per_s"]
        if "target_entropy" in ev:
            ent[it].append((ev["target_entropy"], ev["fragments"]))
    for it, pairs in ent.items():
        tot = sum(n for _, n in pairs)
        if tot:
            # CE floor: the policy cross-entropy can never fall below the
            # mean entropy of its MCTS visit targets (CE = H(target) + KL);
            # the excess column is the actual distance still learnable
            floor = sum(h * n for h, n in pairs) / tot
            iters[it]["ce_floor"] = floor
            if "policy_loss" in iters[it]:
                iters[it]["policy_excess"] = iters[it]["policy_loss"] - floor
    out = []
    for it in sorted(k for k in iters if k is not None):
        row = {"learn_iter": it}
        row.update(iters[it])
        out.append(row)
    return out


def to_markdown(rows):
    lines = [
        "| iter | loss (final epoch) | policy | CE floor | KL excess | "
        "value | sp fragments | sims/s | gate winrate | gate |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        gw = r.get("gate_winrate")
        lines.append(
            "| {it} | {loss} | {pl} | {cf} | {px} | {vl} | {fr} | {ss} | "
            "{gw} | {gr} |".format(
                it=r["learn_iter"],
                loss=_fmt(r.get("loss")),
                pl=_fmt(r.get("policy_loss")),
                cf=_fmt(r.get("ce_floor")),
                px=_fmt(r.get("policy_excess")),
                vl=_fmt(r.get("value_loss")),
                fr=r.get("sp_fragments", ""),
                ss=_fmt(r.get("sp_sims_per_s"), 0),
                gw="" if gw is None else f"{gw:.3f}",
                gr=r.get("gate_result", ""),
            )
        )
    return "\n".join(lines)


def _fmt(x, nd=3):
    return "" if x is None else f"{x:.{nd}f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--metrics", default="runs/bg_full/metrics.jsonl")
    ap.add_argument("--format", choices=("md", "jsonl"), default="md")
    args = ap.parse_args(argv)
    rows = summarize(load_events(args.metrics))
    if args.format == "md":
        print(to_markdown(rows))
    else:
        for r in rows:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
