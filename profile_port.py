#!/usr/bin/env python3
"""Where one full-width search of the PyTorch/CUDA port spends its time.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 profile_port.py

It prints, with the card's name and power limit:

* each row kernel's device time per launch, and its library call's (the
  gather's ``src[ar, idx]``, the scatter's ``index_put_`` on the
  all-unmasked case), from CUDA events around a CUDA graph of 100 launches
  (no host launch cost), beside the time of the same launches back to back
  from Python (what the search pays), in turns (kernel, library, library,
  kernel);
* the device ops (kernels, copies, fills) of one ResNet forward, one legal
  mask and one env step at B = 1024, counted by ``torch.profiler``;
* one backgammon search at the width of ``configs/bg_full.toml`` (1024
  games, 100 simulations, random 256x19 weights from seed 0): its wall time without the profiler, then
  the same search under ``torch.profiler`` tracing the device only, with
  that run's wall time, its device busy time and busy share, its device ops
  per simulation and those outside the forward, mask and step per descent
  level, and the kernels that take the most device time;
* the inference forward at B = 1024 in float32 (TF32) and in bfloat16
  (``DIE_E_BF16=1``'s dtype): its time from CUDA events, then 5 forwards
  under the device profiler, with device busy time and ops per forward
  and the kernels that take the most device time; then the same search
  as above with the bf16 forward, without and under the profiler;
* one training step of the 256x19 net at batch 256 (TF32 convolutions):
  its time from CUDA events over back-to-back steps, then 5 steps under
  ``torch.profiler`` tracing the device only, with their device busy
  share, device ops per step and top kernels.
"""

from __future__ import annotations

import time

import torch

import chip_smoke
from die_e_tpu_torch.core.config import load_config
from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.nets.resnet import forward, make_net
from die_e_tpu_torch.ops import rows as R
from die_e_tpu_torch.search.alpha import alpha_search
from die_e_tpu_torch.train.learner import create_train_state, train_step


def kernel_device_times(dev, b, n, length, reps=100):
    """{name: [(graph_us, python_us), ...]} per launch at [b, n, length]
    bf16, one pair per turn."""
    gen = torch.Generator(device=dev).manual_seed(0)
    src, idx, rows, mask = chip_smoke._row_case(b, n, length, dev, gen, False)
    ar = torch.arange(b, device=dev)
    idx_long = idx.long()
    calls = {
        "gather_rows": lambda: R.gather_rows(src, idx),
        "src[ar, idx]": lambda: src[ar, idx],
        "scatter_rows": lambda: R.scatter_rows(src, idx, rows, mask),
        # every row unmasked, every idx in range: the same store
        "index_put_": lambda: src.index_put_((ar, idx_long), rows),
    }
    graphs = {}
    for name, fn in calls.items():
        fn()  # build before capture
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        graphs[name] = graph
    out = {name: [] for name in calls}
    for pair in (("gather_rows", "src[ar, idx]"), ("scatter_rows", "index_put_")):
        for name in pair + pair[::-1]:
            graph_ms = chip_smoke.time_ms(graphs[name].replay, 5, warmup=1) / reps
            out[name].append((graph_ms * 1e3, chip_smoke.time_ms(calls[name], reps) * 1e3))
    return out


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` tracing the device only.

    Returns (wall_s, busy_us, n_ops, device events by time) for that one run."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    n_ops = sum(e.count for e in events)
    return wall, busy_us, n_ops, sorted(events, key=lambda e: -e.self_device_time_total)


SEED = 0


def forward_dtype_profile(net, obs, reps=5):
    """The inference forward in float32 and in bfloat16: CUDA-event time,
    then ``reps`` forwards under the device profiler."""
    for dtype in (torch.float32, torch.bfloat16):
        def fn(dtype=dtype):
            forward(net, obs, dtype=dtype)

        ms = chip_smoke.time_ms(fn, 20, warmup=3)
        wall, busy_us, n_ops, events = device_profile(lambda: [fn() for _ in range(reps)])
        print(f"forward {dtype} at B={obs.shape[0]}: {ms:.3f} ms back to back (CUDA events, "
              f"20 forwards); under the profiler device busy {busy_us / 1e3 / reps:.3f} ms, "
              f"{n_ops / reps:.0f} device ops a forward; top device events (ms over {reps} "
              "forwards, calls, name):", flush=True)
        for e in events[:10]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:7d}  {e.key[:110]}",
                  flush=True)


def train_step_profile(dev, batch=256, steps=5):
    """A train step's time, then ``steps`` steps under the device profiler."""
    import numpy as np

    st = create_train_state(bg.SPEC, SEED, device=dev)
    obs = bg.observe(chip_smoke._random_states(bg, batch, 12, dev, SEED))
    rng = np.random.default_rng(SEED)
    ps = torch.tensor(rng.dirichlet(np.full(bg.NUM_ACTIONS, 0.05), batch),
                      dtype=torch.float32, device=dev)
    outcome = torch.tensor(rng.choice([-1.0, 0.0, 1.0], batch), dtype=torch.float32,
                           device=dev)
    w = torch.ones(batch, device=dev)

    def step():
        train_step(st, obs, ps, outcome, w)

    ms = chip_smoke.time_ms(step, 20, warmup=3)
    wall, busy_us, n_ops, events = device_profile(lambda: [step() for _ in range(steps)])
    share = busy_us / 1e6 / wall
    print(f"train step: 256x19 at batch {batch}: {ms:.3f} ms a step back to back "
          f"(CUDA events, 20 steps); under the profiler {wall * 1e3 / steps:.3f} ms a step, "
          f"device busy {busy_us / 1e3 / steps:.3f} ms a step = {100 * share:.1f}%, "
          f"{n_ops / steps:.0f} device ops a step", flush=True)
    print("train step top device events by time (ms over %d steps, calls, name):" % steps,
          flush=True)
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:7d}  {e.key[:110]}", flush=True)


def main() -> int:
    dev = resolve_device("cuda:0")
    cfg = load_config(chip_smoke.CONFIG)
    m = cfg.mcts
    games, iterations = cfg.alphazero.num_self_play_batches, m.iterations
    print(f"card: {torch.cuda.get_device_name(0)} ({chip_smoke.smi_name_power()})",
          flush=True)

    length = R.pad_actions(bg.NUM_ACTIONS)
    for name, turns in kernel_device_times(dev, games, iterations + 1, length).items():
        print(f"{name} [{games}, {iterations + 1}, {length}] bf16, per launch: "
              + "; ".join(f"{g:.2f} us in a CUDA graph, {p:.2f} us back to back from Python"
                          for g, p in turns), flush=True)

    net = make_net(bg.SPEC, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = bg.init(torch.randint(0, 2 ** 31 - 1, (games,), generator=gen, device=dev),
                     device=dev)
    obs = bg.observe(states)
    noop = torch.full((games,), bg.NOOP_ACTION, device=dev)
    parts = {"forward": lambda: forward(net, obs), "legal_mask": lambda: bg.legal_mask(states),
             "step": lambda: bg.step(states, noop)}
    for fn in parts.values():
        fn()  # warm-up: cuDNN plans
    ops = {name: device_profile(fn)[2] for name, fn in parts.items()}
    print("device ops per call at B=%d: %s" % (
        games, ", ".join(f"{k} {v}" for k, v in ops.items())), flush=True)

    result = {}

    def search(its, dtype=torch.float32):
        result["res"] = alpha_search(
            bg.ENV, lambda o: forward(net, o, dtype=dtype), states, gen, iterations=its,
            c=m.c, dirichlet_alpha=m.dirichlet_alpha, dirichlet_epsilon=m.dirichlet_epsilon,
            negamax=m.negamax)

    search(4)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search(iterations)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_levels = result["res"].levels
    wall, busy_us, n_ops, events = device_profile(lambda: search(iterations))
    levels = result["res"].levels
    share = busy_us / 1e6 / wall
    print(f"search: B={games} iterations={iterations} 256x19: "
          f"{plain_wall * 1e3:.1f} ms without the profiler ({plain_levels} descent levels); "
          f"under the profiler (device tracing only) {wall * 1e3:.1f} ms "
          f"({levels} levels), device busy {busy_us / 1e3:.1f} ms = {100 * share:.1f}% "
          f"of that run, idle {100 - 100 * share:.1f}%; {n_ops} device ops, "
          f"{n_ops / iterations:.0f} per simulation", flush=True)
    # the root and every simulation run one forward and one legal mask;
    # every descent level one step
    rest = n_ops - (iterations + 1) * (ops["forward"] + ops["legal_mask"]) \
        - levels * ops["step"]
    print(f"device ops outside forward, legal mask and step (descent, allocation, "
          f"expansion, backup): {rest}, {rest / levels:.1f} per descent level", flush=True)
    print("top device events by time (ms, calls, name):", flush=True)
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} {e.count:7d}  {e.key[:110]}", flush=True)

    forward_dtype_profile(net, obs)
    search(4, torch.bfloat16)  # warm-up
    walls = {torch.float32: [plain_wall], torch.bfloat16: []}
    for dtype in (torch.bfloat16, torch.bfloat16, torch.float32):  # in turns with the first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search(iterations, dtype)
        torch.cuda.synchronize()
        walls[dtype].append(time.perf_counter() - t0)
    wall, busy_us, n_ops, _ = device_profile(lambda: search(iterations, torch.bfloat16))
    print("search without the profiler, ms (f32, bf16, bf16, f32): "
          + ", ".join(f"{w * 1e3:.1f}" for w in (walls[torch.float32][0], *walls[torch.bfloat16],
                                                  walls[torch.float32][1]))
          + f"; with the bf16 forward under the profiler {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}%, "
          f"{n_ops / iterations:.0f} device ops per simulation", flush=True)
    train_step_profile(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
