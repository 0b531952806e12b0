"""Batched array search tree: the port of ``die_e_tpu/search/tree.py``.

The whole search state is a stack of ``[B, N]`` tensors over B lockstep
games with node capacity N, as in the JAX package: children are found by
matching ``parent == cur``, a node is materialized when first visited (so
``N = iterations + 1`` suffices), and env states are never stored (the
descent re-steps the deterministic env along its path).

The only ``[B, N, A]``-sized array is ``prior``: bfloat16, with the action
axis padded to ``pad_actions(A)`` (-1.0, the illegal sentinel, in the
padding) so that it compares directly with the JAX package's store.  One
row is read per selection level (:func:`prior_row`, the ``rows_gather``
kernel on the card) and one written per expansion (:func:`set_prior_row`,
``rows_scatter``).  Unlike the JAX package, ``prior`` is updated IN PLACE:
a :class:`Tree` returned by ``set_prior_row`` shares its store with the one
passed in.  Every other field is replaced, never written.

Node indices are int32 tensors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from die_e_tpu_torch.core.device import PRIOR_DTYPE
from die_e_tpu_torch.ops.rows import gather_rows, pad_actions, scatter_rows

NO_PARENT = -1


@dataclasses.dataclass
class Tree:
    """Stacked search tree over B games, N node slots, A actions.

    prior[b, n, a] is the masked+renormalized policy prior of action ``a``
    at node ``n`` with the sentinel -1.0 marking illegal actions; taken
    actions hold ``-2 - p``.  Only meaningful once ``expanded[b, n]``.
    """

    parent: torch.Tensor       # [B, N] int32, NO_PARENT for root / free slots
    action: torch.Tensor       # [B, N] int32 action leading here from parent
    edge_prior: torch.Tensor   # [B, N] f32 prior of the edge into this node
    prior: torch.Tensor        # [B, N, L] bf16, L = pad_actions(A)
    visits: torch.Tensor       # [B, N] f32
    value_sum: torch.Tensor    # [B, N] f32
    expanded: torch.Tensor     # [B, N] bool
    node_done: torch.Tensor    # [B, N] bool, game over at this node
    node_winner: torch.Tensor  # [B, N] int32, winner at this node (0 = none)
    node_player: torch.Tensor  # [B, N] int32, player to move at this node
    num_expanded: torch.Tensor  # [B, N] int32, children created (rollouts)
    num_legal: torch.Tensor    # [B, N] int32, legal actions (set with prior)
    node_count: torch.Tensor   # [B] int32, allocated nodes per game
    action_count: int = 0      # true A

    @property
    def batch_size(self) -> int:
        return self.parent.shape[0]

    @property
    def capacity(self) -> int:
        return self.parent.shape[1]

    @property
    def num_actions(self) -> int:
        return self.action_count

    @property
    def padded_actions(self) -> int:
        return self.prior.shape[2]

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)


def node_onehot(tree: Tree, idx):
    """[B, N] one-hot of a per-game node index."""
    n = torch.arange(tree.capacity, device=idx.device)
    return idx[:, None] == n


def init_tree(env, states, capacity: int) -> Tree:
    """Preallocate the tree with root nodes (slot 0) for ``states``."""
    done = env.done(states)
    b = done.shape[0]
    n = capacity
    a = env.spec.num_actions
    dev = done.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def root_only(v, dtype):
        t = torch.zeros((b, n), dtype=dtype, device=dev)
        t[:, 0] = v
        return t

    return Tree(
        parent=torch.full((b, n), NO_PARENT, **i32),
        action=torch.full((b, n), -1, **i32),
        edge_prior=torch.zeros((b, n), **f32),
        prior=torch.full((b, n, pad_actions(a)), -1.0, dtype=PRIOR_DTYPE,
                         device=dev),
        visits=torch.zeros((b, n), **f32),
        value_sum=torch.zeros((b, n), **f32),
        expanded=torch.zeros((b, n), dtype=torch.bool, device=dev),
        node_done=root_only(done, torch.bool),
        node_winner=root_only(env.winner(states), torch.int32),
        node_player=root_only(env.player(states), torch.int32),
        num_expanded=torch.zeros((b, n), **i32),
        num_legal=torch.zeros((b, n), **i32),
        node_count=torch.ones((b,), **i32),
        action_count=a,
    )


def node_field(tree: Tree, field, idx):
    """field[b, idx[b]] for a [B, N] field; idx must lie in [0, N)."""
    return field.gather(1, idx.long()[:, None])[:, 0]


def allocate(tree: Tree, env, parent_idx, action_idx, edge_p, mask,
             child_states) -> tuple:
    """Materialize the child reached from ``parent_idx`` via ``action_idx``
    for games where ``mask``; returns (tree, new_node_idx [B]).
    ``child_states`` is the stepped state of the new node; ``edge_p`` the
    prior of the traversed edge, recorded on the node."""
    new_idx = tree.node_count
    sel = node_onehot(tree, new_idx) & mask[:, None]

    def put(v, field):
        return torch.where(sel, v.to(field.dtype)[:, None], field)

    tree = tree.replace(
        parent=put(parent_idx, tree.parent),
        action=put(action_idx, tree.action),
        edge_prior=put(edge_p, tree.edge_prior),
        node_done=put(env.done(child_states), tree.node_done),
        node_winner=put(env.winner(child_states), tree.node_winner),
        node_player=put(env.player(child_states), tree.node_player),
        node_count=tree.node_count + mask.to(torch.int32),
    )
    return tree, new_idx


def pad_rows(tree: Tree, rows):
    """[B, A] f32 rows -> [B, L] rows of the store's dtype, cast first and
    padded with the -1.0 sentinel."""
    out = torch.full((rows.shape[0], tree.padded_actions), -1.0,
                     dtype=tree.prior.dtype, device=rows.device)
    out[:, : rows.shape[1]] = rows.to(tree.prior.dtype)
    return out


def prior_row(tree: Tree, idx):
    """[B, A] f32 prior row of node ``idx`` (the ``rows_gather`` kernel on
    the card)."""
    return gather_rows(tree.prior, idx.to(torch.int32))[:, : tree.num_actions].float()


def set_prior_row(tree: Tree, idx, rows, mask) -> Tree:
    """Install ``rows`` [B, A] as node ``idx``'s prior where ``mask`` (the
    ``rows_scatter`` kernel on the card, in place) and mark it expanded."""
    sel = node_onehot(tree, idx) & mask[:, None]
    nl = (rows >= 0.0).sum(-1).to(torch.int32)
    scatter_rows(tree.prior, idx.to(torch.int32), pad_rows(tree, rows), mask)
    return tree.replace(
        expanded=sel | tree.expanded,
        num_legal=torch.where(sel, nl[:, None], tree.num_legal),
    )


def children_of(tree: Tree, idx):
    """[B, N] bool: materialized children of node ``idx``."""
    return tree.parent == idx[:, None]


def backprop(tree: Tree, leaf_idx, value, mask=None) -> Tree:
    """Add ``value`` and one visit to every node on the leaf->root chain
    (the same value at every level, no sign alternation)."""
    if mask is None:
        mask = torch.ones(tree.batch_size, dtype=torch.bool,
                          device=leaf_idx.device)
    visits, value_sum = tree.visits, tree.value_sum
    cur, active = leaf_idx, mask
    while bool(active.any()):
        oh = node_onehot(tree, cur) & active[:, None]
        visits = visits + oh.to(visits.dtype)
        value_sum = value_sum + torch.where(oh, value[:, None], 0.0)
        nxt = node_field(tree, tree.parent, cur)
        active = active & (nxt != NO_PARENT)
        cur = torch.where(active, nxt, cur)
    return tree.replace(visits=visits, value_sum=value_sum)


def backprop_path(tree: Tree, path, value) -> Tree:
    """Add ``value`` and one visit to every node flagged in ``path`` [B, N]
    (the select descent records its root->leaf chain)."""
    pf = path.to(tree.visits.dtype)
    return tree.replace(
        visits=tree.visits + pf,
        value_sum=tree.value_sum + value[:, None] * pf,
    )


def _root_children_by_action(tree: Tree, values):
    """[B, A] sums of ``values`` [B, N] over the root's children, by
    action."""
    is_root_child = tree.parent == 0
    w = torch.where(is_root_child, values, 0.0)
    act = torch.where(is_root_child, tree.action, 0).long()
    out = torch.zeros((tree.batch_size, tree.num_actions), dtype=w.dtype,
                      device=w.device)
    return out.scatter_add_(1, act, w)


def root_visit_probs(tree: Tree):
    """[B, A] root-children visit-count distribution; all-zero rows mean the
    root had no children (terminal root)."""
    counts = _root_children_by_action(tree, tree.visits)
    total = counts.sum(-1, keepdim=True)
    return torch.where(total > 0, counts / total.clamp_min(1e-9), 0.0)


def root_q_values(tree: Tree):
    """[B, A] root-children mean values; -inf where no child."""
    cv = _root_children_by_action(tree, tree.visits)
    cs = _root_children_by_action(tree, tree.value_sum)
    return torch.where(cv > 0, cs / cv.clamp_min(1e-9), -torch.inf)
