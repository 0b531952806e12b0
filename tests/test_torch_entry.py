"""The port's entry points (``die_e_tpu_torch/entry.py``), the
counterparts of the JAX package's ``__graft_entry__.py``, on the CPU."""

import numpy as np
import torch

from die_e_tpu_torch.entry import LOSS_RTOL, dryrun_multichip, entry


def test_entry_is_the_flagship_forward():
    torch.set_num_threads(1)
    fn, args = entry("cpu")
    net, obs = args
    assert (net.spec.n_filters, net.spec.n_res_blocks) == (256, 19)
    policy, value = fn(*args)
    assert policy.shape == (8, 1352) and value.shape == (8, 1)
    np.testing.assert_allclose(policy.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool(torch.isfinite(value).all())


def test_dryrun_multichip_two_processes():
    """2 gloo processes: the fused step's loss equals one process's on all
    the games within LOSS_RTOL (checked inside), then save, restore,
    continue, and one gate round."""
    r = dryrun_multichip(2, device="cpu", timeout=240)
    assert (r["processes"], r["backend"], r["batch"]) == (2, "gloo", 4)
    assert abs(r["loss"] - r["loss_one_process"]) <= LOSS_RTOL * abs(r["loss_one_process"])
    assert r["fragments"] == r["fragments_one_process"] > 0
    assert np.isfinite(r["resume_loss"]) and r["resume_step"] == 2
    assert r["gate_rounds"] == 1 and r["gate_games"] == 4
