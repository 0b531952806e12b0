"""The port's learner against the JAX package's, on the CPU.

Same weights (flax variables converted by ``die_e_tpu_torch.nets.convert``)
and the same batches, made with numpy from a seed, go through both.
Tolerances, float32 throughout:

* loss and logits: 1e-5 absolute; Adam's moments: 2e-6.  The two
  frameworks sum convolutions and reductions in different orders; flax
  also takes the batch variance as E[x^2] - E[x]^2, the port as
  E[(x - E[x])^2].
* parameters after Adam steps: 5e-5 absolute (1e-4 after an epoch of 4
  steps).  Adam divides each gradient element by its own magnitude, so an
  element whose gradient is near zero carries the relative rounding
  difference of its gradient into a step of up to lr = 1e-3.
* the bias of every convolution: each feeds a BatchNorm in train mode,
  which subtracts the batch mean, so its gradient is zero in exact
  arithmetic and rounding noise in both frameworks; Adam turns that noise
  into steps of up to lr of either sign.  For these the test checks that
  both frameworks moved them by at most lr a step, and their moments
  within the tolerance above.
* BatchNorm running statistics: 1e-5 + 2 * 0.01 * lr * steps.  A running
  mean takes 0.01 of its batch mean each step, and the batch mean moves
  with the noise-driven conv bias above, which the frameworks may step by
  up to lr in opposite directions.

Integer and copy work (compaction, padding, densifying sparse rows) is
compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.nets import resnet as jnet
from die_e_tpu.train import learner as jl
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.nets import resnet as tnet
from die_e_tpu_torch.nets.convert import (
    flax_to_state_dict,
    load_flax_train_state,
    params_to_torch,
)
from die_e_tpu_torch.train import learner as tl

JSPEC = dataclasses.replace(jbg.SPEC, n_filters=8, n_res_blocks=1)
TSPEC = dataclasses.replace(tbg.SPEC, n_filters=8, n_res_blocks=1)
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def batch(n, seed, zero_weight=3):
    """(obs, ps, outcome, weight): backgammon observations a few random
    plies in, sparse temperature-powered visit rows, outcomes in
    {-1, 0, 1} and the last ``zero_weight`` rows at weight 0."""
    rng = np.random.default_rng(seed)
    s = tbg.init(torch.tensor(rng.integers(0, 2 ** 31, n)), device="cpu")
    for _ in range(int(rng.integers(0, 8))):
        m = tbg.legal_mask(s).numpy()
        s = tbg.step(s, torch.tensor([rng.choice(np.nonzero(r)[0]) for r in m]))
    obs = tbg.observe(s).numpy()
    ps = np.zeros((n, tbg.NUM_ACTIONS), np.float32)
    for i in range(n):
        cols = rng.choice(tbg.NUM_ACTIONS, size=int(rng.integers(1, 20)), replace=False)
        v = rng.random(len(cols)).astype(np.float32)
        ps[i, cols] = (v / v.sum()) ** np.float32(1 / 1.25)
    outcome = rng.choice([-1.0, 0.0, 1.0], size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    w[n - zero_weight:] = 0.0
    return obs, ps, outcome, w


def jax_state(seed=0):
    net = jnet.make_net(JSPEC)
    state = jl.create_train_state(net, jax.random.PRNGKey(seed), lr=LR, wd=WD)
    # non-trivial running statistics, so their update is checked
    key = jax.random.PRNGKey(100 + seed)
    stats = jax.tree_util.tree_map(
        lambda x: jax.random.uniform(key, x.shape, minval=0.5, maxval=1.5),
        state.batch_stats)
    return net, state.replace(batch_stats=stats)


def _adam(jstate):
    return jstate.opt_state[1]  # the chain's ScaleByAdamState


def port_state(jstate):
    """The port's TrainState holding the JAX state's weights and moments."""
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    adam = _adam(jstate)
    state = tl.create_train_state(TSPEC, 0, lr=LR, wd=WD, device="cpu")
    return load_flax_train_state(
        state, np_(jstate.params), np_(jstate.batch_stats), int(adam.count),
        np_(adam.mu), np_(adam.nu), int(jstate.step))


def _noise_driven(name):
    """The convolutions' biases (see the module doc)."""
    return "conv" in name and name.endswith(".bias")


def _params(tstate):
    return {k: v.detach().clone() for k, v in tstate.net.named_parameters()}


def assert_states_close(jstate, tstate, atol_params, start=None):
    """``start``: the port's parameters before the steps (needed only when
    a step was taken).  Tolerances as in the module doc."""
    steps = tstate.step
    atol_moments = 2e-6
    atol_stats = 1e-5 + 2 * tnet.BN_MOMENTUM * LR * steps
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    adam = _adam(jstate)
    want = params_to_torch(np_(jstate.params))
    mu, nu = params_to_torch(np_(adam.mu)), params_to_torch(np_(adam.nu))
    opt_state = tstate.opt.state_dict()["state"]
    for i, (name, p) in enumerate(tstate.net.named_parameters()):
        if start is not None and _noise_driven(name):
            for moved in (p.detach() - start[name], want[name] - start[name]):
                assert float(moved.abs().max()) <= LR * int(adam.count) * (1 + 1e-3), name
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=atol_params, rtol=0, err_msg=name)
        if steps == 0:
            continue
        st = opt_state[i]
        assert int(st["step"]) == int(adam.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(),
                                   atol=atol_moments, rtol=0, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(),
                                   atol=atol_moments, rtol=0, err_msg=name)
    sd = tstate.net.state_dict()
    want_sd = flax_to_state_dict({"params": np_(jstate.params),
                                  "batch_stats": np_(jstate.batch_stats)})
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=atol_stats,
                                       rtol=0, err_msg=k)
    assert tstate.step == int(jstate.step)


def test_forward_train_updates_running_stats_like_flax():
    net, jstate = jax_state()
    obs = batch(12, 1)[0]
    (jl_, jv), mutated = jnet.forward_train(net, jstate.variables, jnp.asarray(obs))
    tstate = port_state(jstate)
    tl_, tv = tnet.forward_train(tstate.net, torch.tensor(obs))
    assert not tstate.net.training  # back in eval mode after the call
    np.testing.assert_allclose(tl_.detach().numpy(), np.asarray(jl_), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    assert_states_close(jstate.replace(batch_stats=mutated["batch_stats"]), tstate, 0)


def test_inference_forward_refuses_a_net_in_train_mode():
    net = tnet.make_net(TSPEC, 0, "cpu")
    net.train()
    with pytest.raises(RuntimeError, match="train mode"):
        tnet.forward(net, torch.zeros((1, *TSPEC.obs_shape)))


def test_loss_fn_matches_jax():
    net, jstate = jax_state()
    obs, ps, outcome, w = batch(16, 2)
    jloss, (jbs, jpl, jvl) = jl.loss_fn(net, jstate.params, jstate.batch_stats,
                                        *map(jnp.asarray, (obs, ps, outcome, w)))
    tstate = port_state(jstate)
    with torch.no_grad():
        tloss, tpl, tvl = tl.loss_fn(tstate.net, *map(torch.tensor, (obs, ps, outcome, w)))
    for got, want in ((tloss, jloss), (tpl, jpl), (tvl, jvl)):
        np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=0)
    assert_states_close(jstate.replace(batch_stats=jbs), tstate, 0)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_optax(steps):
    net, jstate = jax_state()
    tx = jl.make_optimizer(LR, WD)
    tstate = port_state(jstate)
    start = _params(tstate)
    for k in range(steps):
        b = batch(16, 10 + k)
        jstate, jm = jl.train_step(net, tx, jstate, *map(jnp.asarray, b))
        tstate, tm = tl.train_step(tstate, *map(torch.tensor, b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0)
        assert bool(tm["nan"]) == bool(jm["nan"]) is False
    assert_states_close(jstate, tstate, 5e-5, start)


def test_train_step_compact_equals_dense_bit_for_bit():
    _, jstate = jax_state()
    a, b = port_state(jstate), port_state(jstate)
    obs, ps, outcome, w = batch(16, 3)
    obs_i8, ps_idx, ps_val = tl.compact_memory(ps, obs)
    _, ma = tl.train_step(a, *map(torch.tensor, (obs, ps, outcome, w)))
    _, mb = tl.train_step_compact(
        b, torch.tensor(obs_i8), torch.tensor(ps_idx.astype(np.int32)),
        torch.tensor(ps_val), torch.tensor(outcome), torch.tensor(w),
        num_actions=tbg.NUM_ACTIONS)
    assert torch.equal(ma["loss"], mb["loss"])
    for (k, x), (_, y) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("n,dense_rows", [(40, False), (7, True), (0, False)])
def test_compact_memory_matches_jax(n, dense_rows):
    obs, ps, _, _ = batch(max(n, 1), 4)
    obs, ps = obs[:n], ps[:n]
    if dense_rows:
        ps = np.full_like(ps, 1.0 / ps.shape[1])
    got, want = tl.compact_memory(ps, obs), jl.compact_memory(ps, obs)
    if want is None:
        assert got is None
        return
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


def test_compact_memory_refuses_non_int8_observations():
    obs, ps, _, _ = batch(5, 5)
    obs = obs + 0.5
    assert tl.compact_memory(ps, obs) is None and jl.compact_memory(ps, obs) is None


@pytest.mark.parametrize("n,bs,bucket", [(50, 16, 64), (64, 16, 64), (70, 32, 48)])
def test_upload_epoch_data_padding_matches_jax(n, bs, bucket):
    obs, ps, outcome, _ = batch(n, 6)
    want = jl.upload_epoch_data(obs, ps, outcome, bs, bucket=bucket)
    got = tl.upload_epoch_data(obs, ps, outcome, bs, bucket=bucket, device="cpu")
    assert got.padded_rows == want.padded_rows and got.n == int(want.n)
    assert got.num_actions == want.num_actions
    for f in ("obs", "ps_idx", "ps_val", "outcome"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)).astype(
                                          getattr(got, f).numpy().dtype), err_msg=f)
    assert got.obs.dtype == torch.int8
    assert tl.upload_epoch_data(obs[:0], ps[:0], outcome[:0], bs, device="cpu") is None


def test_train_epoch_device_matches_jax_with_the_same_perm():
    net, jstate = jax_state()
    tx = jl.make_optimizer(LR, WD)
    tstate = port_state(jstate)
    obs, ps, outcome, _ = batch(50, 7)
    jdata = jl.upload_epoch_data(obs, ps, outcome, 16, bucket=64)
    tdata = tl.upload_epoch_data(obs, ps, outcome, 16, bucket=64, device="cpu")
    perm = np.random.default_rng(8).permutation(64).astype(np.int32)
    start = _params(tstate)
    jms, tms = [], []
    jstate = jl.train_epoch_device(net, tx, jstate, None, jdata, 16, jms,
                                   perm=jnp.asarray(perm))
    tl.train_epoch_device(tstate, tdata, 16, metrics_out=tms, perm=torch.tensor(perm))
    assert tms[0]["nan"] == jms[0]["nan"] == 0
    for k in ("loss", "policy_loss", "value_loss"):
        np.testing.assert_allclose(tms[0][k], jms[0][k], atol=1e-5, rtol=0)
    assert tstate.step == 4  # the padded batches are real steps
    assert_states_close(jstate, tstate, 1e-4, start)


def test_train_epoch_host_loop_matches_jax_with_the_same_perm():
    """The host loop pads only its last batch; JAX draws its permutation
    from a key, which the port is handed as ``perm``."""
    net, jstate = jax_state()
    tx = jl.make_optimizer(LR, WD)
    tstate = port_state(jstate)
    obs, ps, outcome, _ = batch(40, 9)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, 40))
    start = _params(tstate)
    jms, tms = [], []
    jstate = jl.train_epoch(net, tx, jstate, key, obs, ps, outcome, 16, jms)
    tl.train_epoch(tstate, obs, ps, outcome, 16, metrics_out=tms, perm=perm)
    assert tstate.step == 3
    np.testing.assert_allclose(tms[0]["loss"], jms[0]["loss"], atol=1e-5, rtol=0)
    assert_states_close(jstate, tstate, 1e-4, start)


@pytest.mark.parametrize("device_loop", [True, False])
def test_nan_input_raises(device_loop):
    _, jstate = jax_state()
    tstate = port_state(jstate)
    obs, ps, outcome, _ = batch(20, 11)
    obs = obs.copy()
    obs[3, 0, 0, 0] = np.nan
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(FloatingPointError):
        if device_loop:
            data = tl.upload_epoch_data(obs, ps, outcome, 16, bucket=32, device="cpu")
            tl.train_epoch_device(tstate, data, 16, gen)
        else:
            tl.train_epoch(tstate, obs, ps, outcome, 16, gen)


def test_optimizer_is_coupled_adam():
    net = tnet.make_net(TSPEC, 0, "cpu")
    opt = tl.make_optimizer(net.parameters(), LR, WD)
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (LR, (0.9, 0.999), 1e-8, WD)
    assert not g.get("decoupled_weight_decay", False)
