"""Batched NN-guided MCTS (PUCT): the port of ``die_e_tpu/search/alpha.py``.

Same search, step for step: PUCT score ``q + c * sqrt(parent_visits) /
(child_visits + 1) * prior`` with q = 0 for unvisited children; the root
gets one batched policy, per-game Dirichlet noise over its legal actions,
a masked renormalisation and one preset visit; each iteration selects a
leaf, evaluates it in one batched forward, expands it and backs its value
up the path; terminal leaves back up +-1 against the root player; the
result is the root-children visit distribution.  ``negamax`` scores the
exploitation term from the perspective of the player to move.

The descent is the JAX package's ``lax.while_loop`` on ``any(active)``
written as a Python loop: it syncs with the host once per level.  Argmax
ties take the first maximum in both frameworks.

JAX's random draws cannot be reproduced here: the Dirichlet noise uses
``torch._standard_gamma`` and sampling ``torch.multinomial``, each with the
caller's ``torch.Generator``.  With ``dirichlet_epsilon = 0`` and a
deterministic ``eval_fn`` the search is exact, and the tests hold it so.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from die_e_tpu_torch.envs.base import freeze_where, map_state
from die_e_tpu_torch.ops.rows import scatter_rows
from die_e_tpu_torch.search.tree import (
    Tree,
    allocate,
    backprop_path,
    children_of,
    init_tree,
    node_field,
    node_onehot,
    pad_rows,
    prior_row,
    root_visit_probs,
    set_prior_row,
)

EvalFn = Callable[[torch.Tensor], tuple]  # obs [B,H,W,C] -> (policy, value)


@dataclasses.dataclass
class SearchResult:
    visit_probs: torch.Tensor  # [B, A] normalized root visit counts
    root_value: torch.Tensor   # [B] mean value at root
    tree: Tree
    levels: int                # descent levels run, summed over iterations


def _masked_renorm(policy, legal):
    """Zero illegal entries and renormalize rows; illegal slots become the
    -1.0 sentinel."""
    p = torch.where(legal, policy, 0.0)
    s = p.sum(-1, keepdim=True)
    p = p / s.clamp_min(1e-30)
    return torch.where(legal, p, -1.0)


def _dirichlet_legal(gen, alpha, legal):
    """Per-game Dirichlet over the legal actions."""
    conc = torch.full(legal.shape, float(alpha), dtype=torch.float32,
                      device=legal.device)
    g = torch._standard_gamma(conc, generator=gen)
    g = torch.where(legal, g, 0.0)
    return g / g.sum(-1, keepdim=True).clamp_min(1e-30)


def select_and_allocate(tree: Tree, env, root_states, c: float,
                        root_player=None):
    """Descend every game from its root by PUCT until an unexpanded node,
    materializing first-visited children on the way.  Returns (tree,
    leaf_idx [B], leaf_states, path [B, N], levels).

    Materialized children are scored on the [B, N] node arrays;
    unmaterialized ones (q = 0, visits = 0) on the [B, A] prior row, where
    a taken action is marked ``-2 - p`` at allocation so that ``p >= 0``
    means legal and unmaterialized.  The current state is carried down the
    descent and re-stepped with the traversed action each level."""
    b = tree.batch_size
    dev = tree.parent.device
    cur = torch.zeros(b, dtype=torch.int32, device=dev)
    cur_state = root_states
    path = node_onehot(tree, cur)  # the root is always on the chain
    active = node_field(tree, tree.expanded, cur)
    actions = torch.arange(tree.num_actions, device=dev)
    levels = 0
    while bool(active.any()):
        levels += 1
        p_row = prior_row(tree, cur)                        # [B, A]
        vc = node_field(tree, tree.visits, cur)             # [B]
        explore = c * torch.sqrt(vc)

        # materialized children, on [B, N]
        is_child = children_of(tree, cur)
        q = torch.where(
            tree.visits > 0, tree.value_sum / tree.visits.clamp_min(1e-9), 0.0)
        if root_player is not None:
            cur_player = node_field(tree, tree.node_player, cur)
            sign = (cur_player == root_player).float() * 2.0 - 1.0
            q = q * sign[:, None]
        u = explore[:, None] / (tree.visits + 1.0) * tree.edge_prior
        score_n = torch.where(is_child, q + u, -torch.inf)
        best_n = score_n.argmax(-1)
        best_n_score = score_n.amax(-1)

        # unmaterialized children, on [B, A]
        legal_untaken = p_row >= 0.0
        score_a = explore[:, None] * p_row.clamp_min(0.0)
        score_a = torch.where(legal_untaken, score_a, -torch.inf)
        best_a = score_a.argmax(-1)
        best_a_score = score_a.amax(-1)

        choose_new = best_a_score > best_n_score
        oh_a = best_a[:, None] == actions
        edge_p = p_row.gather(1, best_a[:, None])[:, 0].clamp_min(0.0)
        do_alloc = active & choose_new
        act_n = node_field(tree, tree.action, best_n)
        action_next = torch.where(choose_new, best_a.to(torch.int32), act_n)
        next_state = env.step(cur_state, action_next)
        tree, new_idx = allocate(
            tree, env, cur, best_a, edge_p, do_alloc, next_state)
        # mark the taken action on the parent's row, in place: -2 - p in
        # f32, then cast to the store's bf16
        marked = torch.where(oh_a, -2.0 - p_row, p_row)
        scatter_rows(tree.prior, cur, pad_rows(tree, marked), do_alloc)
        nxt = torch.where(choose_new, new_idx, best_n.to(torch.int32))
        cur = torch.where(active, nxt, cur)
        cur_state = freeze_where(~active, cur_state, next_state)
        path = path | (node_onehot(tree, cur) & active[:, None])
        active = active & node_field(tree, tree.expanded, cur)
    return tree, cur, cur_state, path, levels


def expand(tree: Tree, leaf, prior_rows, mask) -> Tree:
    """Install priors at ``leaf`` and mark it expanded."""
    return set_prior_row(tree, leaf, prior_rows, mask)


@torch.no_grad()
def alpha_search(
    env,
    eval_fn: EvalFn,
    states,
    gen: torch.Generator,
    iterations: int = 100,
    c: float = 2.0,
    dirichlet_alpha: float = 0.3,
    dirichlet_epsilon: float = 0.25,
    negamax: bool = False,
) -> SearchResult:
    """Run PUCT search for a batch of root states on their device.

    ``eval_fn(obs [B,H,W,C]) -> (policy_softmax [B,A], value [B,1])``;
    ``gen`` is a generator on the states' device."""
    tree = init_tree(env, states, capacity=iterations + 1)
    b = tree.batch_size
    dev = tree.parent.device

    # --- root: batched policy + per-game Dirichlet over legal actions
    root_policy, _ = eval_fn(env.observe(states))
    root_legal = env.legal_mask(states)
    noise = _dirichlet_legal(gen, dirichlet_alpha, root_legal)
    mixed = (1.0 - dirichlet_epsilon) * root_policy + dirichlet_epsilon * noise
    root_prior = _masked_renorm(mixed, root_legal)
    root_done = tree.node_done[:, 0]
    root = torch.zeros(b, dtype=torch.int32, device=dev)
    tree = expand(tree, root, root_prior, ~root_done)
    visits = tree.visits.clone()
    visits[:, 0] = 1.0
    tree = tree.replace(visits=visits)
    root_player = env.player(states)

    # --- search loop: one batched NN call per iteration
    levels = 0
    for _ in range(iterations):
        tree, leaf, leaf_states, path, n = select_and_allocate(
            tree, env, states, c, root_player if negamax else None)
        levels += n
        policy, value = eval_fn(env.observe(leaf_states))
        legal = env.legal_mask(leaf_states)
        prior_rows = _masked_renorm(policy, legal)

        is_term = node_field(tree, tree.node_done, leaf)
        w = node_field(tree, tree.node_winner, leaf)
        term_val = torch.where(
            w == root_player, 1.0, torch.where(w == -root_player, -1.0, 0.0))
        nn_v = value[:, 0]
        if negamax:
            # the value head predicts the outcome from the LEAF player's
            # perspective; convert to the root player's
            leaf_player = node_field(tree, tree.node_player, leaf)
            nn_v = nn_v * (leaf_player * root_player).float()
        v = torch.where(is_term, term_val, nn_v)
        tree = expand(tree, leaf, prior_rows, ~is_term)
        tree = backprop_path(tree, path, v)

    root_v = tree.value_sum[:, 0] / tree.visits[:, 0].clamp_min(1e-9)
    return SearchResult(visit_probs=root_visit_probs(tree), root_value=root_v,
                        tree=tree, levels=levels)


def temperature_probs(visit_probs, temperature: float):
    """pi^(1/tau) renormalized."""
    p = visit_probs.clamp_min(0.0).pow(1.0 / temperature)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-30)


def sample_action(gen, visit_probs, temperature: float):
    """[B] int32 weighted sample from the temperature distribution.  An
    all-zero row gives the last action index, which callers mask by their
    done flags."""
    p = temperature_probs(visit_probs, temperature)
    empty = p.sum(-1) <= 0.0
    last = torch.zeros_like(p)
    last[:, -1] = 1.0
    p = torch.where(empty[:, None], last, p)
    return torch.multinomial(p, 1, generator=gen)[:, 0].to(torch.int32)


def get_next_move(env, eval_fn: EvalFn, state, gen: torch.Generator, game: int = 0,
                  iterations: int = 100, c: float = 2.0, dirichlet_alpha: float = 0.3,
                  dirichlet_epsilon: float = 0.25, temperature: float = 1.25,
                  negamax: bool = False) -> int:
    """The next move for game ``game`` of a batched state (a one-game
    batch by default), for debugging and interactive play: a one-game
    PUCT search and a temperature sample, both drawing from ``gen``.
    Returns a Python int; a terminal state gives the noop."""
    one = map_state(lambda t: t[game:game + 1], state)
    res = alpha_search(env, eval_fn, one, gen, iterations=iterations, c=c,
                       dirichlet_alpha=dirichlet_alpha,
                       dirichlet_epsilon=dirichlet_epsilon, negamax=negamax)
    if res.visit_probs.sum() <= 0.0:
        return env.spec.noop_action
    return int(sample_action(gen, res.visit_probs, temperature)[0])
