"""The fused self-play + training step: the port of
``die_e_tpu/parallel/distributed.py``.

The JAX package shards the game batch over a device mesh inside one
program and lets XLA insert the gradient all-reduce.  The port runs one
process per card: each rank self-plays its own games, and the SGD step on
all ranks' fragments together is data-parallel over the state's group
(``train/learner.py``: BatchNorm statistics and the loss's weight sum over
the whole batch, gradients summed).  Every rank draws its games with its
own generator, so a rank plays the same games it would play alone.
"""

from __future__ import annotations

import torch

from die_e_tpu_torch.parallel.multihost import all_reduce_
from die_e_tpu_torch.train.learner import TrainState, train_step
from die_e_tpu_torch.train.self_play import PROB_QUANT, self_play_from_states


def flatten_trajectory(traj, temperature: float):
    """(obs, ps, outcome, weight) over all [T*B] rows of a trajectory, the
    visit rows dequantized and raised to 1/temperature; weight 1 for valid
    fragments.  Each padding row is replaced by the nearest preceding valid
    row (the first valid row before any), so that the BatchNorm statistics,
    which no weight masks, stay on the data."""
    t, b = traj.obs.shape[:2]
    obs = traj.obs.reshape(t * b, *traj.obs.shape[2:])
    ps = torch.pow(traj.probs.reshape(t * b, -1).to(torch.float32) / PROB_QUANT,
                   1.0 / temperature)
    outcome = traj.outcome.reshape(t * b)
    valid = traj.valid.reshape(t * b)
    weight = valid.to(torch.float32)
    pos = torch.where(valid, torch.arange(t * b, device=valid.device), -1)
    fill = torch.cummax(pos, 0).values  # the last valid row so far
    fill = torch.where(fill >= 0, fill, torch.argmax(valid.to(torch.int32)))
    return obs[fill], ps[fill], outcome[fill], weight


def train_iteration(env, state: TrainState, eval_fn, init_states, gen: torch.Generator,
                    iterations: int = 8, c: float = 2.0, dirichlet_alpha: float = 0.3,
                    dirichlet_epsilon: float = 0.25, temperature: float = 1.25,
                    round_limit: int = 16):
    """One actor + learner step: self-play ``init_states`` (this rank's
    games) with ``gen``, then one Adam step on every fragment (weight 0
    where invalid), data-parallel over ``state.group`` when it has one.
    Returns (state, metrics) with the metrics summed over the group: the
    loss and its parts, ``fragments`` and ``decisive_games``."""
    traj = self_play_from_states(
        env, eval_fn, init_states, gen, iterations=iterations, c=c,
        dirichlet_alpha=dirichlet_alpha, dirichlet_epsilon=dirichlet_epsilon,
        temperature=temperature, round_limit=round_limit,
    )
    obs, ps, outcome, weight = flatten_trajectory(traj, temperature)
    n = weight.sum()
    if state.group is not None:
        all_reduce_(n, state.group)
    state, m = train_step(state, obs, ps, outcome, weight, n.clamp_min(1.0))
    out = torch.stack([m["loss"], m["policy_loss"], m["value_loss"], weight.sum(),
                       (traj.winner != 0).sum().to(torch.float32)])
    if state.group is not None:
        all_reduce_(out, state.group)
    keys = ("loss", "policy_loss", "value_loss", "fragments", "decisive_games")
    return state, {**dict(zip(keys, out.tolist())), "nan": bool(m["nan"])}
