"""Training state, loss and optimizer: the port of
``die_e_tpu/train/learner.py``.

* loss = CrossEntropy(policy logits, stored visit distribution) +
  MSE(value, outcome), means over the real (weighted) rows of a batch; the
  CE target is the unnormalised temperature power, as stored.
* optimizer = ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=wd)``: coupled L2 decay added to the gradient before the
  moments, which is what the JAX package's optax chain
  (``add_decayed_weights`` then ``scale_by_adam``) computes.
* NaN/Inf: every step returns a flag on the device (loss or any new
  weight not finite); the epoch loops read the flags once per epoch and
  raise ``FloatingPointError``.

A :class:`TrainState` holds the one net that is trained, in place.  It is
in eval mode outside :func:`~die_e_tpu_torch.nets.resnet.forward_train`,
so the search may evaluate it between epochs (:func:`net_eval_fn`).

Two epoch loops, as in the JAX package:

* :func:`train_epoch_device`: the iteration's memory is uploaded once
  (:func:`upload_epoch_data`, padded to ``EPOCH_BUCKET`` rows with wrapped
  rows at weight 0) and each epoch permutes the padded rows on the device.
  Padded batches are real Adam steps and their rows enter the BatchNorm
  statistics, as in the JAX package.
* :func:`train_epoch`: a host loop that uploads each batch, padding only
  the last batch with wrapped rows at weight 0 (offline training, and
  ``learn`` on an empty memory).

Data parallel (:func:`set_process_group`): every rank holds the same
memory and draws the same permutation, and takes its contiguous
``1/world`` of the rows of each batch.  BatchNorm statistics are those of
the whole batch (``nets/resnet.py``), each rank divides its weighted sums
by the whole batch's weight sum, and the gradients are summed over the
ranks, so the step is the one-process step on the whole batch; Adam then
runs identically on every rank.  A mean of per-rank means would be wrong
here: the weight-0 padding sits at the end of the bucket, so the last
rank may see almost no weight.  The JAX package's scan chunking exists for
the TPU's program-length limit and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from die_e_tpu_torch.core.device import COMPUTE_DTYPE, resolve_device
from die_e_tpu_torch.nets.resnet import (
    BatchNorm,
    PolicyValueNet,
    forward,
    forward_train,
    make_net,
)
from die_e_tpu_torch.parallel.multihost import all_reduce_, batch_slice

# table rows are padded to a multiple of this, as in the JAX package, so
# that the epochs take the same steps on the same padded rows
EPOCH_BUCKET = 16384

_NAN_MESSAGE = "NaN/Inf in loss or weights during training"


@dataclasses.dataclass
class TrainState:
    """The trained net, its optimizer and the count of steps taken;
    ``group`` is the process group of a data-parallel state (None: one
    process)."""

    net: PolicyValueNet
    opt: torch.optim.Adam
    step: int = 0
    group: object = None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device


def set_process_group(state: TrainState, group) -> TrainState:
    """Make ``state`` data-parallel over ``group`` (see the module doc), or
    single-process with None; a group of one rank is a single process."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    state.group = group
    for m in state.net.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return state


def _rank_world(state: TrainState):
    if state.group is None:
        return 0, 1
    return dist.get_rank(state.group), dist.get_world_size(state.group)


def make_optimizer(params, lr: float = 1e-3, wd: float = 1e-4) -> torch.optim.Adam:
    """Adam with coupled weight decay (see the module doc)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)


def create_train_state(spec, seed: int = 0, lr: float = 1e-3, wd: float = 1e-4,
                       device=None) -> TrainState:
    """A fresh net from ``seed`` and a fresh optimizer on ``device`` (cuda
    unless the caller asks for the CPU)."""
    net = make_net(spec, seed, device)
    return TrainState(net=net, opt=make_optimizer(net.parameters(), lr, wd))


def net_eval_fn(net: PolicyValueNet, dtype=COMPUTE_DTYPE):
    """``eval_fn(obs) -> (softmax policy, value)`` over the net in eval
    mode, the shape the search expects; the net computes in ``dtype``
    (``core/device.py::compute_dtype``), its outputs are float32."""

    def eval_fn(obs):
        return forward(net, obs, dtype=dtype)

    return eval_fn


def loss_fn(net: PolicyValueNet, obs, ps, outcome, weight, n=None):
    """(loss, policy_loss, value_loss): CE(policy, ps) + MSE(value,
    outcome), weighted sums over the rows divided by ``n``, by default
    these rows' weight sum (at least 1); a data-parallel step passes the
    whole batch's.  Runs the net in train mode, so the BatchNorm running
    statistics are updated."""
    logits, value = forward_train(net, obs)
    if n is None:
        n = weight.sum().clamp_min(1.0)
    ce = -(ps * F.log_softmax(logits, dim=-1)).sum(-1)
    policy_loss = (ce * weight).sum() / n
    value_loss = (((value[:, 0] - outcome) ** 2) * weight).sum() / n
    return policy_loss + value_loss, policy_loss, value_loss


def train_step(state: TrainState, obs, ps, outcome, weight, n=None):
    """One Adam step on one batch, in place.  Returns (state, metrics) with
    the metrics as device scalars; ``nan`` flags a non-finite loss or
    weight after the step.

    Data-parallel (``state.group``): the rows are this rank's part of the
    batch, ``n`` is the whole batch's weight sum, the gradients are summed
    over the ranks, and the losses returned are this rank's parts of the
    batch's (they sum to it)."""
    state.opt.zero_grad(set_to_none=True)
    loss, pl, vl = loss_fn(state.net, obs, ps, outcome, weight, n)
    loss.backward()
    if state.group is not None:
        _sum_grads(state)
    state.opt.step()
    state.step += 1
    with torch.no_grad():
        peak = torch.stack(torch._foreach_norm(list(state.net.parameters()), float("inf")))
        nan = ~torch.isfinite(loss) | ~torch.isfinite(peak).all()
    return state, {"loss": loss.detach(), "policy_loss": pl.detach(),
                   "value_loss": vl.detach(), "nan": nan}


def _sum_grads(state: TrainState) -> None:
    """Sum every parameter's gradient over the state's group, in one
    collective."""
    grads = [p.grad for p in state.net.parameters()]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), state.group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _densify(ps_idx, ps_val, num_actions: int):
    """Sparse rows (column indices, values; padding slots at column 0 with
    value 0) -> dense [B, A] f32, adding into zeros as the JAX package does."""
    ps = torch.zeros((ps_idx.shape[0], num_actions), dtype=torch.float32,
                     device=ps_val.device)
    return ps.scatter_add_(1, ps_idx.long(), ps_val)


def train_step_compact(state: TrainState, obs_i8, ps_idx, ps_val, outcome, weight,
                       num_actions: int, n=None):
    """:func:`train_step` on compact inputs: int8 observations and sparse
    probability rows, densified on the device; the same math after that."""
    ps = _densify(ps_idx, ps_val, num_actions)
    return train_step(state, obs_i8.float(), ps, outcome, weight, n)


def _obs_int8_exact(obs) -> bool:
    """True when the observations are small exact integers (int8-safe)."""
    return bool(obs.size) and bool(
        np.abs(obs).max() < 127 and np.array_equal(obs, np.rint(obs))
    )


def _sparsify_rows(ps):
    """CSR-pack the nonzero columns of each probability row: returns
    (ps_idx uint16 [N, K], ps_val f32 [N, K]) with K the largest row
    support rounded up to a multiple of 64, at most the row width.
    Padding slots point at column 0 with value 0."""
    rows, cols = np.nonzero(ps)
    counts = np.bincount(rows, minlength=ps.shape[0])
    kmax = int(counts.max()) if counts.size else 1
    k = min(ps.shape[1], max(64, ((kmax + 63) // 64) * 64))
    offsets = np.zeros(len(rows), np.int64)
    if len(rows):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        offsets = np.arange(len(rows)) - starts[rows]
    ps_idx = np.zeros((ps.shape[0], k), np.uint16)
    ps_val = np.zeros((ps.shape[0], k), np.float32)
    ps_idx[rows, offsets] = cols.astype(np.uint16)
    ps_val[rows, offsets] = ps[rows, cols]
    return ps_idx, ps_val


def compact_memory(ps, obs):
    """(obs int8, ps_idx uint16 [N, K], ps_val f32 [N, K]) for the compact
    step, or None when the memory is not compactable (observations that are
    not int8-exact, or rows so dense that packing saves nothing)."""
    if not _obs_int8_exact(obs):
        return None
    ps_idx, ps_val = _sparsify_rows(ps)
    if ps_idx.shape[1] >= ps.shape[1] // 2:
        return None
    return obs.astype(np.int8), ps_idx, ps_val


_AUTO_COMPACT = object()


def _epoch_metrics(sums, nan, n_batches: int, metrics_out, group=None) -> None:
    """One host sync per epoch: append the batch means and raise on NaN.
    With a ``group``, the sums are this rank's parts and are summed over
    the ranks first."""
    if group is not None:
        all_reduce_(sums, group)
        all_reduce_(nan, group)
    loss, pl, vl = sums.tolist()
    nan = int(nan.item())
    if metrics_out is not None:
        metrics_out.append({"loss": loss / n_batches, "policy_loss": pl / n_batches,
                            "value_loss": vl / n_batches, "nan": nan})
    if nan > 0:
        raise FloatingPointError(_NAN_MESSAGE)


def _accumulate(sums, nan, m):
    sums += torch.stack((m["loss"], m["policy_loss"], m["value_loss"]))
    nan += m["nan"].to(torch.int32)


def train_epoch(state: TrainState, obs, ps, outcome, batch_size: int,
                gen: Optional[torch.Generator] = None,
                metrics_out: Optional[list] = None, compact=_AUTO_COMPACT,
                perm=None) -> TrainState:
    """One shuffled pass over the host memory in fixed-size batches,
    uploading each batch (data-parallel: this rank's part of it); the last
    partial batch is padded with wrapped rows at zero weight.  Batches
    travel compact (int8 obs + sparse rows) whenever the memory allows it;
    the math is the dense step's.

    ``perm`` (numpy [N]) is injectable for tests; by default it is drawn
    from ``gen``, a generator on the state's device."""
    dev = state.device
    n = obs.shape[0]
    num_actions = ps.shape[1]
    if compact is _AUTO_COMPACT:
        compact = compact_memory(ps, obs)
    if perm is None:
        perm = torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()
    mine = batch_slice(batch_size, *_rank_world(state))
    sums = torch.zeros(3, dtype=torch.float32, device=dev)
    nan = torch.zeros((), dtype=torch.int32, device=dev)
    n_batches = 0
    for start in range(0, n, batch_size):
        idx = perm[start:start + batch_size]
        w = np.ones(len(idx), np.float32)
        if len(idx) < batch_size:
            # wrapped real rows at zero weight keep the batch shape and the
            # BatchNorm statistics on the data; the loss means are exact
            pad = batch_size - len(idx)
            idx = np.concatenate([idx, perm[np.arange(pad) % n]])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        n_w = torch.tensor(max(float(w.sum()), 1.0), device=dev)
        idx, w = idx[mine], w[mine]
        if compact is not None:
            obs_i8, ps_idx, ps_val = compact
            batch = (obs_i8[idx], ps_idx[idx].astype(np.int32), ps_val[idx],
                     outcome[idx], w)
        else:
            batch = (obs[idx], ps[idx], outcome[idx], w)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch)
        if compact is not None:
            state, m = train_step_compact(state, *batch, num_actions=num_actions, n=n_w)
        else:
            state, m = train_step(state, *batch, n_w)
        _accumulate(sums, nan, m)
        n_batches += 1
    if n_batches:
        _epoch_metrics(sums, nan, n_batches, metrics_out, state.group)
    return state


@dataclasses.dataclass
class EpochData:
    """One learn iteration's compact memory, on the device.  Rows beyond
    ``n`` are wrapped copies of real rows and train at weight 0."""

    obs: torch.Tensor      # [Np, H, W, C] int8 (f32 when not int8-exact)
    ps_idx: torch.Tensor   # [Np, K] int32 sparse column indices
    ps_val: torch.Tensor   # [Np, K] f32 values (0 in padding slots)
    outcome: torch.Tensor  # [Np] f32
    n: int                 # real rows
    num_actions: int

    @property
    def padded_rows(self) -> int:
        return self.obs.shape[0]


def upload_epoch_data(obs, ps, outcome, batch_size: int, bucket: int = EPOCH_BUCKET,
                      device=None) -> Optional[EpochData]:
    """Sparsify and bucket-pad the memory on the host and place it on
    ``device`` (cuda unless the caller asks for the CPU).  None for an
    empty memory (the caller takes the host loop)."""
    dev = resolve_device(device)
    n = obs.shape[0]
    if n == 0:
        return None
    ps_idx, ps_val = _sparsify_rows(ps)
    obs_t = obs.astype(np.int8 if _obs_int8_exact(obs) else np.float32)

    n_pad = ((n + bucket - 1) // bucket) * bucket
    if n_pad % batch_size:
        n_pad = ((n_pad + batch_size - 1) // batch_size) * batch_size
    wrap = np.arange(n, n_pad) % n

    def put(x):
        x = np.concatenate([x, x[wrap]]) if n_pad > n else x
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return EpochData(obs=put(obs_t), ps_idx=put(ps_idx.astype(np.int32)),
                     ps_val=put(ps_val), outcome=put(outcome.astype(np.float32)),
                     n=n, num_actions=ps.shape[1])


def train_epoch_device(state: TrainState, data: EpochData, batch_size: int,
                       gen: Optional[torch.Generator] = None,
                       metrics_out: Optional[list] = None, perm=None) -> TrainState:
    """One shuffled epoch over the device-resident ``data``: a permutation
    of the padded rows, then ``padded_rows / batch_size`` steps, each on
    the rows it gathers, at weight 0 for padding rows.  Each real row
    trains once an epoch, and each batch's loss means over its real rows.
    Data-parallel (``state.group``), each rank steps on its contiguous part
    of every batch (``gen`` must draw the same permutation on every rank).

    ``perm`` (a [Np] tensor on the device) is injectable for tests; by
    default it is drawn from ``gen``, a generator on the device."""
    dev = state.device
    n_pad = data.padded_rows
    total_batches = n_pad // batch_size
    if perm is None:
        perm = torch.randperm(n_pad, generator=gen, device=dev)
    mine = batch_slice(batch_size, *_rank_world(state))
    sums = torch.zeros(3, dtype=torch.float32, device=dev)
    nan = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(total_batches):
        rows = perm[j * batch_size:(j + 1) * batch_size]
        w = (rows < data.n).to(torch.float32)
        n = w.sum().clamp_min(1.0)
        rows, w = rows[mine], w[mine]
        ps = _densify(data.ps_idx[rows], data.ps_val[rows], data.num_actions)
        state, m = train_step(state, data.obs[rows].float(), ps,
                              data.outcome[rows], w, n)
        _accumulate(sums, nan, m)
    _epoch_metrics(sums, nan, total_batches, metrics_out, state.group)
    return state
