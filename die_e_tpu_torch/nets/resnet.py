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

Inference may run in another compute dtype (``dtype`` of :func:`forward`,
bfloat16 under ``core/device.py::compute_dtype``), with flax's semantics
for ``make_net(spec, dtype=...)``: the input is cast to it; each conv and
dense layer computes in it, its float32 parameters cast at the call (one
set of float32 weights serves every dtype, so training and checkpoints do
not change); each BatchNorm takes its input to float32 and normalises
with the float32 running statistics, so the residual stream is float32;
``tanh`` runs in the dtype; policy and value are returned as float32.
Training (:func:`forward_train`) is float32 always.

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


def _at(layer, x, dtype):
    """A conv or dense ``layer`` computing in ``dtype``: its input and its
    float32 parameters cast at the call, as flax's ``dtype=`` does."""
    if dtype == COMPUTE_DTYPE:
        return layer(x)
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if isinstance(layer, nn.Conv2d):
        return layer._conv_forward(x.to(dtype), w, b)
    return F.linear(x.to(dtype), w, b)


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training BatchNorm whose statistics are those of the rows of every
    rank of ``bn.group`` together, as flax's BatchNorm reduces over the
    whole global batch under a sharded jit.

    Forward: one all-reduce of the per-channel (sum, sum of squares) and
    the element count, in float64, so that E[x^2] - E[x]^2 (flax's own
    formula) loses nothing to cancellation before the float32 result.
    Backward: one all-reduce of (sum dy, sum dy * xhat).  Two collectives
    a layer a step, the fewest global statistics allow.  The weight and
    bias gradients returned are this rank's own sums; the data-parallel
    step sums them over the ranks with the other gradients."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        from die_e_tpu_torch.parallel.multihost import all_reduce_

        c = x.shape[1]
        xd = x.double()
        s = all_reduce_(torch.cat([xd.sum((0, 2, 3)), (xd * xd).sum((0, 2, 3)),
                                   xd.new_full((1,), x.numel() // c)]), bn.group)
        count = s[2 * c]
        mean = s[:c] / count
        var = (s[c:2 * c] / count - mean * mean).to(x.dtype)
        mean, count = mean.to(x.dtype), count.to(x.dtype)
        xc = x - mean[None, :, None, None]
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
        invstd = torch.rsqrt(var + bn.eps)
        xhat = xc * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.group = bn.group
        return xhat * weight[None, :, None, None] + bias[None, :, None, None]

    @staticmethod
    def backward(ctx, dy):
        from die_e_tpu_torch.parallel.multihost import all_reduce_

        xhat, weight, invstd, count = ctx.saved_tensors
        c = dy.shape[1]
        dbias = dy.sum((0, 2, 3))
        dweight = (dy * xhat).sum((0, 2, 3))
        sums = all_reduce_(torch.cat([dbias, dweight]), ctx.group) / count
        dx = (weight * invstd)[None, :, None, None] * (
            dy - sums[:c][None, :, None, None] - xhat * sums[c:][None, :, None, None])
        return dx, dweight, dbias, None


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward updates the running
    variance with the biased batch variance, as flax does; torch's own
    update uses the unbiased one, n/(n-1) larger (n = B*H*W).  The output
    is normalised with the biased variance in both.

    ``group``: a process group of more than one rank makes the training
    statistics those of all its ranks' rows (:class:`_CrossRankBatchNorm`;
    ``train/learner.py::set_process_group`` sets it)."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x.to(COMPUTE_DTYPE))
        if self.group is not None:
            return _CrossRankBatchNorm.apply(x, self.weight, self.bias, self)
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

    def forward(self, x, dtype=COMPUTE_DTYPE):
        y = F.relu(self.bn0(_at(self.conv0, x, dtype)))
        return F.relu(self.bn1(_at(self.conv1, y, dtype)) + x)


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

    def forward(self, obs, dtype=COMPUTE_DTYPE):
        """``dtype``: the inference compute dtype (module doc); training
        calls it at float32."""
        x = obs.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(_at(self.stem_conv, x, dtype)))
        for block in self.blocks:
            x = block(x, dtype)
        p = F.relu(self.policy_bn(_at(self.policy_conv, x, dtype)))
        p = _at(self.policy_fc, self._flatten_nhwc(p), dtype)
        v = F.relu(self.value_bn(_at(self.value_conv, x, dtype)))
        v = torch.tanh(_at(self.value_fc, self._flatten_nhwc(v), dtype))
        return p.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)


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
def forward(net: PolicyValueNet, obs, softmax_policy: bool = True, dtype=COMPUTE_DTYPE):
    """Inference forward: softmaxed policy + tanh value, BatchNorm in eval
    mode, convs and dense layers in ``dtype`` (module doc); float32
    outputs."""
    logits, value = _eval_net(net)(obs, dtype)
    if softmax_policy:
        return torch.softmax(logits, dim=-1), value
    return logits, value


@torch.no_grad()
def forward_policy(net: PolicyValueNet, obs):
    """Policy-only forward."""
    logits, _ = _eval_net(net)(obs)
    return torch.softmax(logits, dim=-1)
