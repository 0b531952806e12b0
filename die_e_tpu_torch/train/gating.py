"""Model gating, candidate against the current best: the port of
``die_e_tpu/train/gating.py``.

With no best model the candidate is promoted at once.  Otherwise an arena
match is played, the candidate as player 1 (side -1): promoted at winrate
>= ``promote_threshold`` (0.55), the best kept at <= ``keep_threshold``
(0.45), and kept on inconclusive results between.  With
``gate_sequential`` the match is played in blocks of ``gate_block`` games
and stops once the decision of the full ``num_games`` match is determined
(forced, or predictively at error ``gate_eps`` per stop).
"""

from __future__ import annotations

from math import lgamma, log
from typing import Optional

import numpy as np

from die_e_tpu_torch.arena.versus import Agent, Player, play
from die_e_tpu_torch.core.device import COMPUTE_DTYPE
from die_e_tpu_torch.nets.resnet import PolicyValueNet
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train.learner import net_eval_fn


def _binom_sf_ge(k: int, n: int, p: float) -> float:
    """P(Bin(n, p) >= k), exact by log-pmf summation."""
    if k <= 0:
        return 1.0
    if k > n:
        return 0.0
    p = min(max(p, 1e-9), 1.0 - 1e-9)
    lp, lq = log(p), log(1.0 - p)
    ks = np.arange(k, n + 1, dtype=np.float64)
    logpmf = (
        np.array([lgamma(n + 1) - lgamma(x + 1) - lgamma(n - x + 1) for x in ks])
        + ks * lp + (n - ks) * lq
    )
    m = logpmf.max()
    return float(min(1.0, np.exp(m) * np.exp(logpmf - m).sum()))


class SequentialGate:
    """Early-stopping decision rule for the gate arena.

    The decision is binary: promote iff a fixed ``num_games`` match would
    reach ``threshold``.  After each block it stops when the outcome is
    forced, or when the predictive probability of promotion (the remaining
    games ~ Bin(rem, p_hat) at the Laplace-smoothed running winrate) is
    >= ``1 - eps`` or <= ``eps``.  Run to exhaustion, it is the fixed rule.
    """

    def __init__(self, num_games: int, threshold: float, eps: float = 0.02):
        self.num_games = int(num_games)
        self.need_total = int(np.ceil(threshold * num_games - 1e-9))
        self.eps = float(eps)
        self.wins = 0
        self.games = 0
        self.decision: Optional[str] = None

    def update(self, wins: int, games: int) -> Optional[str]:
        if self.decision is not None:
            return self.decision
        self.wins += int(wins)
        self.games += int(games)
        rem = self.num_games - self.games
        need = self.need_total - self.wins
        if need <= 0:
            self.decision = "promote"  # forced: threshold already cleared
        elif need > rem:
            self.decision = "keep"     # forced: unreachable
        elif rem == 0:
            self.decision = "keep"
        else:
            p_hat = (self.wins + 1) / (self.games + 2)
            p_win = _binom_sf_ge(need, rem, p_hat)
            if p_win >= 1.0 - self.eps:
                self.decision = "promote"
            elif p_win <= self.eps:
                self.decision = "keep"
        return self.decision

    @property
    def winrate(self) -> float:
        return self.wins / max(self.games, 1)


def gate(env, candidate: PolicyValueNet, gen, mcts_cfg, arena_cfg,
         temperature: float, models_base: str = "./models", metrics=None,
         compact: bool = False, dtype=COMPUTE_DTYPE) -> bool:
    """Run the gate for the ``candidate`` net (eval mode) with ``gen`` on
    its device; promotes it (writes the ``best`` checkpoint) and returns
    True iff it became the new best.  ``compact``: the arena re-packs live
    games as games finish (``arena/versus.py::play``); ``dtype``: both
    nets' inference compute dtype."""
    best_path = ckpt.best_model_path(env.spec.name, models_base)
    if not best_path.exists():
        if metrics is not None:
            metrics.log("gate", result="no_best_promoted")
        ckpt.save_variables(candidate.state_dict(), best_path)
        return True

    best_net = PolicyValueNet(candidate.spec).to(next(candidate.parameters()).device)
    ckpt.restore_variables(best_path, best_net)
    p_cand = Player(Agent.MODEL, net_eval_fn(candidate, dtype))
    p_best = Player(Agent.MODEL, net_eval_fn(best_net, dtype))

    def match(n):
        return play(env, p_cand, p_best, gen, mcts_cfg, temperature=temperature,
                    num_games=n, round_limit=arena_cfg.round_limit, metrics=metrics,
                    compact=compact)

    sequential = bool(arena_cfg.gate_sequential)
    if sequential:
        seq = SequentialGate(arena_cfg.num_games, arena_cfg.promote_threshold,
                             eps=arena_cfg.gate_eps)
        wins_p1 = wins_p2 = draws = games = 0
        while seq.decision is None:
            n = min(arena_cfg.gate_block, arena_cfg.num_games - games)
            res = match(n)
            wins_p1 += res.wins_p1
            wins_p2 += res.wins_p2
            draws += res.draws
            games += n
            seq.update(res.wins_p1, n)  # draws count as candidate losses
        winrate = seq.winrate
        promoted = seq.decision == "promote"
    else:
        res = match(arena_cfg.num_games)
        winrate = res.winrate
        wins_p1, wins_p2, draws, games = res.wins_p1, res.wins_p2, res.draws, res.n_games
        promoted = winrate >= arena_cfg.promote_threshold
    if metrics is not None:
        metrics.log(
            "gate", winrate=winrate, wins_p1=wins_p1, wins_p2=wins_p2,
            draws=draws, games=games, sequential=sequential,
            result="promoted" if promoted
            else ("best_kept" if winrate <= arena_cfg.keep_threshold
                  else "inconclusive_kept"),
        )
    if promoted:
        ckpt.save_variables(candidate.state_dict(), best_path)
    return promoted
