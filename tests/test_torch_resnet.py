"""The port's ResNet against the flax one, on the same weights.

The flax variables are converted by ``die_e_tpu_torch.nets.convert`` and
both nets run in eval mode on the CPU in float32.  Tolerances: the two
frameworks sum the convolutions in different orders, so outputs agree to
float32 rounding accumulated over the net's depth: 1e-4 absolute for a
32x2 net, 2e-4 for the trained 256x19 checkpoint (whose logits reach
magnitudes of tens).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu.nets import resnet as jnet
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.nets import resnet as tnet
from die_e_tpu_torch.nets.convert import flax_to_state_dict

BEST = Path(__file__).resolve().parents[1] / "runs/bg_full/models/backgammon/best"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _obs(b, seed):
    """Observations of backgammon positions a few random plies in."""
    rng = np.random.default_rng(seed)
    s = tbg.init(torch.tensor(rng.integers(0, 2 ** 31, b)), device="cpu")
    for _ in range(6):
        m = tbg.legal_mask(s).numpy()
        a = np.array([rng.choice(np.nonzero(r)[0]) for r in m])
        s = tbg.step(s, torch.tensor(a))
    return tbg.observe(s).numpy()


def _ported(spec, variables):
    net = tnet.PolicyValueNet(spec).eval()
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    net.load_state_dict(flax_to_state_dict(np_vars))
    return net


def _compare(spec, variables, obs, atol):
    jn = jnet.make_net(spec)
    jp, jv = jnet.forward(jn, variables, jnp.asarray(obs), softmax_policy=False)
    net = _ported(spec, variables)
    tp, tv = tnet.forward(net, torch.tensor(obs), softmax_policy=False)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=atol, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol, rtol=0)
    sp = tnet.forward_policy(net, torch.tensor(obs)).numpy()
    np.testing.assert_allclose(
        sp, np.asarray(jnet.forward_policy(jn, variables, jnp.asarray(obs))),
        atol=atol, rtol=0)
    return net


@pytest.mark.parametrize("spec_name", ["backgammon", "tictactoe"])
def test_parameter_count_matches_flax(spec_name):
    jspec = {"backgammon": jbg.SPEC, "tictactoe": jttt.SPEC}[spec_name]
    tspec = {"backgammon": tbg.SPEC, "tictactoe": tttt.SPEC}[spec_name]
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    shapes = jax.eval_shape(lambda: jnet.init_params(jnet.make_net(jspec),
                                                     jax.random.PRNGKey(0)))
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    net = tnet.PolicyValueNet(tspec)
    assert sum(p.numel() for p in net.parameters()) == n_flax


@pytest.mark.parametrize("seed", [0, 1])
def test_small_random_net_matches_flax(seed):
    spec = dataclasses.replace(jbg.SPEC, n_filters=32, n_res_blocks=2)
    variables = jnet.init_params(jnet.make_net(spec), jax.random.PRNGKey(seed))
    # non-trivial BatchNorm statistics, so the conversion of each is checked
    key = jax.random.PRNGKey(100 + seed)
    stats = jax.tree_util.tree_map(
        lambda x: jax.random.uniform(key, x.shape, minval=0.5, maxval=1.5),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tspec = dataclasses.replace(tbg.SPEC, n_filters=32, n_res_blocks=2)
    _compare(tspec, variables, _obs(5, seed), atol=1e-4)


def test_trained_checkpoint_matches_flax():
    from die_e_tpu.train.checkpoint import restore_variables

    if not BEST.exists():
        pytest.fail(f"the trained checkpoint is missing at {BEST}")
    template = jnet.init_params(jnet.make_net(jbg.SPEC), jax.random.PRNGKey(0))
    variables = restore_variables(BEST, template)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(leaves) == 250
    assert sum(x.size for x in leaves) == 23_597_632
    _compare(tbg.SPEC, variables, _obs(3, 7), atol=2e-4)


def test_make_net_is_seeded_and_in_eval_mode():
    spec = dataclasses.replace(tttt.SPEC, n_filters=8, n_res_blocks=1)
    state = torch.get_rng_state()
    a = tnet.make_net(spec, seed=3, device="cpu")
    b = tnet.make_net(spec, seed=3, device="cpu")
    assert torch.equal(torch.get_rng_state(), state)  # global generator untouched
    assert not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
