"""BatchNorm-padding probe on a checkpoint and real self-play rows; the
port of ``scripts/bn_padding_probe.py``.

DIVERGENCES row 17: the on-device epoch pads the final partial batch with
wrapped rows at weight 0, and those rows still enter the BatchNorm batch
statistics (the reference trains on the natural-size final batch).  This
probe measures what that does to a model.  Two arms start from the same
restored checkpoint, each with a fresh optimizer, and take the same
``--steps`` Adam steps on full batches of ``--batch`` rows; then the final
batch is either B/2 real rows plus B/2 wrapped rows at weight 0 (padded
arm) or the B/2 real rows alone (natural arm).  It prints one JSON line:
the relative L2 distance between the arms' BatchNorm running statistics
and between their parameters, and both arms' eval-mode loss (CE + MSE) on
a held-out batch of ``--batch`` real rows.

``--model-path`` is a port checkpoint (a ``variables.pt`` directory, as
``learn`` writes them); ``--memory`` a ``memory.npz`` (a glob: the last
match in sorted order), the layout both packages write
(``train/replay.py``).  The first ``steps * B + B/2 + B`` rows are used.

Usage:

    python -m die_e_tpu_torch.scripts.bn_padding_probe \\
        --model-path models/backgammon/model_30 \\
        --memory 'data/backgammon/run-*/lrn-30/sp-0/memory.npz' [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.nets.resnet import PolicyValueNet, forward
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train.learner import TrainState, make_optimizer, train_step


def rows_needed(steps: int, batch: int) -> int:
    """The training rows of both arms and the held-out batch."""
    return steps * batch + batch // 2 + batch


def _arm(net: PolicyValueNet, obs, ps, outcome, steps, batch, lr, wd,
         pad_last: bool) -> PolicyValueNet:
    """A copy of ``net`` after ``steps`` full batches and the final one,
    padded or natural, with a fresh optimizer."""
    arm = copy.deepcopy(net)
    state = TrainState(net=arm, opt=make_optimizer(arm.parameters(), lr, wd))
    ones = torch.ones(batch, device=obs.device)
    for i in range(steps):
        sl = slice(batch * i, batch * (i + 1))
        train_step(state, obs[sl], ps[sl], outcome[sl], ones)
    lo, half = steps * batch, batch // 2
    if pad_last:  # half real rows + half wrapped rows at weight 0
        idx = torch.cat([torch.arange(lo, lo + half), torch.arange(0, half)]).to(obs.device)
        w = torch.cat([ones[:half], torch.zeros_like(ones[:half])])
    else:  # the natural-size final batch (reference semantics)
        idx, w = torch.arange(lo, lo + half, device=obs.device), ones[:half]
    train_step(state, obs[idx], ps[idx], outcome[idx], w)
    return arm


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1) for t in tensors]).double().cpu().numpy()


def _stats(net: PolicyValueNet) -> np.ndarray:
    return _flat(v for k, v in net.state_dict().items()
                 if k.endswith(("running_mean", "running_var")))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def _eval_loss(net: PolicyValueNet, obs, ps, outcome) -> float:
    """Eval-mode CE + MSE, means over the rows."""
    logits, value = forward(net, obs, softmax_policy=False)
    ce = -(ps * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    mse = ((value[:, 0] - outcome) ** 2).mean()
    return float(ce + mse)


def probe(net: PolicyValueNet, obs, ps, outcome, *, steps: int = 3, batch: int = 32,
          lr: float = 2.5e-4, wd: float = 1e-4) -> dict:
    """The probe's numbers for ``net`` (unchanged) and the first
    :func:`rows_needed` rows of ``obs``, ``ps`` and ``outcome`` (host
    arrays), on the net's device."""
    need = rows_needed(steps, batch)
    if len(obs) < need:
        raise ValueError(f"memory too small: {len(obs)} < {need} rows")
    dev = next(net.parameters()).device
    obs, ps, outcome = (torch.as_tensor(np.asarray(x[:need], np.float32), device=dev)
                        for x in (obs, ps, outcome))
    pad, nat = (_arm(net, obs, ps, outcome, steps, batch, lr, wd, p) for p in (True, False))
    held = slice(steps * batch + batch // 2, need)
    l_pad, l_nat = (_eval_loss(n, obs[held], ps[held], outcome[held]) for n in (pad, nat))
    return {
        "rel_batch_stats_delta": _rel(_stats(pad), _stats(nat)),
        "rel_params_delta": _rel(_flat(pad.parameters()), _flat(nat.parameters())),
        "eval_loss_padded": l_pad, "eval_loss_natural": l_nat,
        "eval_loss_rel_delta": abs(l_pad - l_nat) / max(abs(l_nat), 1e-9),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-path", required=True, help="a port checkpoint directory")
    ap.add_argument("--memory", required=True,
                    help="memory.npz path (glob ok) with real rows")
    ap.add_argument("--steps", type=int, default=3,
                    help="full batches before the padded/natural final one")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.00025,
                    help="the run's current lr (configs/bg_full.toml)")
    ap.add_argument("--wd", type=float, default=0.0001)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    matches = sorted(glob.glob(args.memory))
    if not matches:
        raise SystemExit(f"no memory file matches {args.memory!r}")
    mem_path = matches[-1]
    net = ckpt.load_net(args.model_path, bg.SPEC, dev)
    with np.load(mem_path) as z:
        rows = [z[k][:rows_needed(args.steps, args.batch)] for k in ("states", "ps", "outcomes")]
    out = probe(net, *rows, steps=args.steps, batch=args.batch, lr=args.lr, wd=args.wd)
    print(json.dumps({"metric": "bn_padding_probe", "model": args.model_path,
                      "memory": mem_path, "steps": args.steps, "batch": args.batch, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
