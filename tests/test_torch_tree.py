"""The port's tree ops against the JAX package's, bit for bit, on random
trees.

A random tree is a random parent forest grown node by node (root children
with distinct actions, as the search makes them), with random statistics,
flags and a random bf16 prior store.  Every op's every output field is
compared exactly: the values summed by ``root_visit_probs`` are integers,
and every other float op is elementwise in the same order as the JAX
package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.search import tree as jtree
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.search import tree as ttree

A = jbg.NUM_ACTIONS
FIELDS = [f.name for f in dataclasses.fields(ttree.Tree) if f.name != "action_count"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def random_tree(seed, b=6, n=12):
    rng = np.random.default_rng(seed)
    lp = ttree.pad_actions(A)
    parent = np.full((b, n), -1, np.int32)
    action = np.full((b, n), -1, np.int32)
    count = rng.integers(1, n + 1, b).astype(np.int32)
    for g in range(b):
        acts = rng.permutation(A)[:n]
        for i in range(1, count[g]):
            parent[g, i] = rng.integers(0, i)
            action[g, i] = acts[i]
    prior = rng.standard_normal((b, n, lp)).astype(np.float32)
    prior[rng.random((b, n, lp)) < 0.3] = -1.0
    prior[:, :, A:] = -1.0
    f = dict(
        parent=parent, action=action,
        edge_prior=rng.random((b, n)).astype(np.float32),
        prior=prior,
        visits=rng.integers(0, 20, (b, n)).astype(np.float32),
        value_sum=rng.standard_normal((b, n)).astype(np.float32),
        expanded=rng.random((b, n)) < 0.5,
        node_done=rng.random((b, n)) < 0.2,
        node_winner=rng.integers(-1, 2, (b, n)).astype(np.int32),
        node_player=rng.choice([-1, 1], (b, n)).astype(np.int32),
        num_expanded=rng.integers(0, 5, (b, n)).astype(np.int32),
        num_legal=rng.integers(0, 50, (b, n)).astype(np.int32),
        node_count=count,
    )
    r = lp // 128
    jt = jtree.Tree(**{k: jnp.asarray(v) for k, v in f.items() if k != "prior"},
                    prior=jnp.asarray(prior.reshape(b, n, r, 128), jnp.bfloat16),
                    action_count=A)
    tt = ttree.Tree(**{k: torch.tensor(v) for k, v in f.items() if k != "prior"},
                    prior=torch.tensor(prior).to(torch.bfloat16), action_count=A)
    return jt, tt, rng


def assert_trees_equal(jt, tt):
    b, n = tt.parent.shape
    for name in FIELDS:
        want = np.asarray(jnp.asarray(getattr(jt, name), jnp.float32)
                          if name == "prior" else getattr(jt, name))
        got = getattr(tt, name)
        got = (got.float() if name == "prior" else got).numpy()
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=name)


def _states(seed, b):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 31, b)
    js = jax.vmap(jbg.init)(jnp.asarray(seeds, jnp.uint32))
    ts = tbg.init(torch.tensor(seeds), device="cpu")
    # a few games are over, so done/winner are not all zero
    off = np.where(rng.random((b, 2)) < 0.3, 15, 0).astype(np.int32)
    js = js.replace(off=jnp.asarray(off))
    ts.off = torch.tensor(off)
    return js, ts


@pytest.mark.parametrize("seed", range(3))
def test_init_tree_matches_jax(seed):
    js, ts = _states(seed, 7)
    assert_trees_equal(jtree.init_tree(jbg.ENV, js, 9), ttree.init_tree(tbg.ENV, ts, 9))


@pytest.mark.parametrize("seed", range(4))
def test_node_addressing_matches_jax(seed):
    jt, tt, rng = random_tree(seed)
    b, n = tt.parent.shape
    idx = rng.integers(0, n, b).astype(np.int32)
    ji, ti = jnp.asarray(idx), torch.tensor(idx)
    np.testing.assert_array_equal(ttree.node_onehot(tt, ti).numpy(),
                                  np.asarray(jtree.node_onehot(jt, ji)))
    np.testing.assert_array_equal(ttree.children_of(tt, ti).numpy(),
                                  np.asarray(jtree.children_of(jt, ji)))
    for name in FIELDS:
        if name in ("prior", "node_count"):
            continue
        jf = getattr(jt, name)
        if jf.dtype == jnp.bool_:
            jf = jf.astype(jnp.int32)  # the JAX reduction wants numbers
        want = np.asarray(jtree.node_field(jt, jf, ji))
        got = ttree.node_field(tt, getattr(tt, name), ti).numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=name)
    np.testing.assert_array_equal(ttree.prior_row(tt, ti).numpy(),
                                  np.asarray(jtree.prior_row(jt, ji)))


@pytest.mark.parametrize("seed", range(4))
def test_allocate_matches_jax(seed):
    jt, tt, rng = random_tree(seed)
    b, n = tt.parent.shape
    js, ts = _states(seed, b)
    parent = rng.integers(0, n, b).astype(np.int32)
    act = rng.integers(0, A, b).astype(np.int32)
    edge = rng.random(b).astype(np.float32)
    mask = rng.random(b) < 0.6
    jt2, jnew = jtree.allocate(jt, jbg.ENV, jnp.asarray(parent), jnp.asarray(act),
                               jnp.asarray(edge), jnp.asarray(mask), js)
    tt2, tnew = ttree.allocate(tt, tbg.ENV, torch.tensor(parent), torch.tensor(act),
                               torch.tensor(edge), torch.tensor(mask), ts)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    assert_trees_equal(jt2, tt2)


@pytest.mark.parametrize("seed", range(4))
def test_set_prior_row_matches_jax(seed):
    jt, tt, rng = random_tree(seed)
    b, n = tt.parent.shape
    idx = rng.integers(0, n, b).astype(np.int32)
    rows = rng.random((b, A)).astype(np.float32)
    rows[rng.random((b, A)) < 0.5] = -1.0
    mask = rng.random(b) < 0.6
    jt2 = jtree.set_prior_row(jt, jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(mask))
    tt2 = ttree.set_prior_row(tt, torch.tensor(idx), torch.tensor(rows), torch.tensor(mask))
    assert tt2.prior is tt.prior  # the store is updated in place
    assert_trees_equal(jt2, tt2)


@pytest.mark.parametrize("seed", range(4))
def test_backprop_matches_jax(seed):
    jt, tt, rng = random_tree(seed)
    b, n = tt.parent.shape
    leaf = (rng.random(b) * tt.node_count.numpy()).astype(np.int32)
    value = rng.standard_normal(b).astype(np.float32)
    mask = rng.random(b) < 0.7
    assert_trees_equal(
        jtree.backprop(jt, jnp.asarray(leaf), jnp.asarray(value), jnp.asarray(mask)),
        ttree.backprop(tt, torch.tensor(leaf), torch.tensor(value), torch.tensor(mask)))
    path = rng.random((b, n)) < 0.3
    assert_trees_equal(
        jtree.backprop_path(jt, jnp.asarray(path), jnp.asarray(value)),
        ttree.backprop_path(tt, torch.tensor(path), torch.tensor(value)))


@pytest.mark.parametrize("seed", range(4))
def test_root_statistics_match_jax(seed):
    jt, tt, _ = random_tree(seed)
    np.testing.assert_array_equal(ttree.root_visit_probs(tt).numpy(),
                                  np.asarray(jtree.root_visit_probs(jt)))
    np.testing.assert_array_equal(ttree.root_q_values(tt).numpy(),
                                  np.asarray(jtree.root_q_values(jt)))
