"""The AlphaZero policy/value ResNet: the port of
``die_e_tpu/nets/resnet.py``.

Same topology and the same per-game sizes from :class:`GameSpec`:

* init block: conv 3x3 pad 1 (C_in -> F) -> BatchNorm -> ReLU
* N res blocks: conv-BN-ReLU-conv-BN-add-ReLU
* policy head: conv 3x3 (F -> 32) -> BN -> ReLU -> flatten -> dense -> A
* value head: conv 3x3 (F -> 3) -> BN -> ReLU -> flatten -> dense -> 1 -> tanh

Inputs and the flatten order of both heads are NHWC, as in the JAX package,
so the dense layers take the JAX package's weights transposed and nothing
else (:mod:`die_e_tpu_torch.nets.convert`); the convolutions run NCHW
inside.  BatchNorm is eps 1e-5 and momentum 0.99 in flax's convention
(:class:`BatchNorm`).

A net is in eval mode everywhere except inside :func:`forward_train`, and
the inference :func:`forward` refuses a net in train mode, so a net left
training never reaches the search (the JAX package passes ``train=False``
explicitly).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from die_e_tpu_torch.core.device import COMPUTE_DTYPE, resolve_device
from die_e_tpu_torch.envs.base import GameSpec

BN_EPS = 1e-5
BN_MOMENTUM = 0.01  # flax momentum 0.99


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward updates the running
    variance with the biased batch variance, as flax does; torch's own
    update uses the unbiased one, n/(n-1) larger (n = B*H*W).  The output
    is normalised with the biased variance in both."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ResBlock(nn.Module):
    """conv-BN-ReLU-conv-BN-add-ReLU."""

    def __init__(self, filters: int):
        super().__init__()
        self.conv0, self.bn0 = _conv(filters, filters), BatchNorm(filters)
        self.conv1, self.bn1 = _conv(filters, filters), BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(y)) + x)


class PolicyValueNet(nn.Module):
    """obs [B, H, W, C] -> (policy_logits [B, A], value [B, 1])."""

    def __init__(self, spec: GameSpec):
        super().__init__()
        self.spec = spec
        h, w, c = spec.obs_shape
        f = spec.n_filters
        self.stem_conv, self.stem_bn = _conv(c, f), BatchNorm(f)
        self.blocks = nn.ModuleList(ResBlock(f) for _ in range(spec.n_res_blocks))
        self.policy_conv, self.policy_bn = _conv(f, 32), BatchNorm(32)
        self.policy_fc = nn.Linear(32 * h * w, spec.num_actions)
        self.value_conv, self.value_bn = _conv(f, 3), BatchNorm(3)
        self.value_fc = nn.Linear(3 * h * w, 1)
        self.eval()

    @staticmethod
    def _flatten_nhwc(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, obs):
        x = obs.to(COMPUTE_DTYPE).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks:
            x = block(x)
        p = F.relu(self.policy_bn(self.policy_conv(x)))
        p = self.policy_fc(self._flatten_nhwc(p))
        v = F.relu(self.value_bn(self.value_conv(x)))
        v = torch.tanh(self.value_fc(self._flatten_nhwc(v)))
        return p, v


def make_net(spec: GameSpec, seed: int = 0, device=None) -> PolicyValueNet:
    """A net in eval mode on ``device`` (cuda by default), its weights
    drawn from ``seed`` without touching the global generator."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = PolicyValueNet(spec)
    return net.to(dev)


def forward_train(net: PolicyValueNet, obs):
    """Training forward: raw policy logits and value with BatchNorm on the
    batch statistics, updating the running statistics in place.  The net is
    in train mode for this call only."""
    net.train()
    try:
        return net(obs)
    finally:
        net.eval()


def _eval_net(net: PolicyValueNet) -> PolicyValueNet:
    if net.training:
        raise RuntimeError("inference forward on a net in train mode")
    return net


@torch.no_grad()
def forward(net: PolicyValueNet, obs, softmax_policy: bool = True):
    """Inference forward: softmaxed policy + tanh value, BatchNorm in eval
    mode."""
    logits, value = _eval_net(net)(obs)
    if softmax_policy:
        return torch.softmax(logits, dim=-1), value
    return logits, value


@torch.no_grad()
def forward_policy(net: PolicyValueNet, obs):
    """Policy-only forward."""
    logits, _ = _eval_net(net)(obs)
    return torch.softmax(logits, dim=-1)
