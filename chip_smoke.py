#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``die_e_tpu_torch``) on one NVIDIA GPU.

Phases, each reported on one flushed line with the elapsed seconds:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: the port's CUDA sources, one ``nvcc`` call each, with the
   ``-Xptxas -v`` register and shared-memory lines;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes ([1024, 101, 2048] bf16), at
   B = 1000 with false mask rows, an idx at N-1 and idx out of range; then
   each kernel's time, the plain version's and, where one PyTorch call
   computes the same function, that call's, with CUDA events;
4. reference: the port on the card against the port on the CPU on small
   inputs (legal masks and a search exactly, the ResNet within a stated
   tolerance), and a breakdown of one search iteration's parts at full
   width;
5. self-play: the main path, ``train/self_play.py::self_play`` at the full
   width of ``configs/bg_full.toml`` (1024 games, 100 simulations, the
   256x19 ResNet, A = 1352) for 2 rounds (the one cut), with both kernels'
   launch counts, which must be above 0;
6. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

Any failed phase makes the script exit non-zero without the result line;
so does a missing card and a run over the time budget.  Weights are random,
made from ``--seed``; the script writes only into the ignored ``build/``.

Usage (from the root of a checkout):

    python3 chip_smoke.py                       # on the card, as above
    python3 chip_smoke.py --device cpu --games 4 --iterations 4 \\
        --filters 8 --blocks 1                  # CPU rehearsal, no result
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 600.0      # the whole run, build included
CONFIG = os.path.join(ROOT, "configs", "bg_full.toml")
ROUNDS = 2            # the one cut: self-play rounds (of the config's round limit)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
T0 = time.perf_counter()


def elapsed() -> float:
    return time.perf_counter() - T0


def say(phase: str, msg: str) -> None:
    print(f"[{elapsed():7.1f}s] {phase}: {msg}", flush=True)


def check_budget(phase: str) -> None:
    if elapsed() > BUDGET_S:
        raise RuntimeError(
            f"over the time budget after {phase}: {elapsed():.1f}s > {BUDGET_S:.0f}s")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    # smaller sizes for a CPU rehearsal; the card runs the config's widths
    p.add_argument("--games", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--filters", type=int, default=None)
    p.add_argument("--blocks", type=int, default=None)
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` on the card, with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them; raises
    when it gives none."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed (rc {smi.returncode}): {smi.stderr.strip()}")
    return lines[0]


def phase_device(dev) -> dict:
    import torch

    if dev.type == "cpu":
        say("device", "cpu rehearsal: no card, no device numbers")
        return {}
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = smi_name_power()
    say("device", f"{name} x{count}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(smi_line, flush=True)
    return {"kind": name, "count": count, "smi": smi_line}


def phase_build(dev) -> None:
    from die_e_tpu_torch.ops import build

    if dev.type == "cpu":
        say("build", "skipped on the cpu (kernels run only on the card)")
        return
    info = build.build("rows.cu")
    say("build", f"rows.cu in {info['seconds']:.2f}s -> {os.path.relpath(info['path'], ROOT)}")
    for ln in info["ptxas"]:
        print(f"    {ln}", flush=True)


def _row_case(b, n, length, dev, gen, false_rows: bool):
    import torch

    src = torch.randn((b, n, length), generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, n, (b,), generator=gen, device=dev).to(torch.int32)
    idx[0] = n - 1
    rows = torch.randn((b, length), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    if false_rows:
        mask = torch.rand(b, generator=gen, device=dev) < 0.75
        idx[1] = -1  # out of range: zero row on gather, no write on scatter
        idx[2] = n
    return src, idx, rows, mask


def phase_kernels(dev, b, n, length, seed) -> list:
    """Each kernel against its plain version, bit for bit; then times."""
    import torch

    from die_e_tpu_torch.ops import rows as R

    gen = torch.Generator(device=dev).manual_seed(seed)
    on_card = dev.type == "cuda"
    max_err = {"gather_rows": 0.0, "scatter_rows": 0.0}
    cases = [(b, False), (b - 24 if b >= 32 else b + 3, True)]  # 1024 -> 1000
    for bb, false_rows in cases:
        src, idx, rows, mask = _row_case(bb, n, length, dev, gen, false_rows)
        got = R.gather_rows(src, idx)
        want = R._gather_rows_plain(src, idx)
        dst_k = R.scatter_rows(src.clone(), idx, rows, mask)
        dst_p = R._scatter_rows_plain(src, idx, rows, mask)
        if on_card:
            torch.cuda.synchronize()
        for name, x, y in (("gather_rows", got, want), ("scatter_rows", dst_k, dst_p)):
            if not torch.equal(x, y):
                raise AssertionError(f"{name} differs from its plain version at B={bb}")
            err = (x.float() - y.float()).abs().max().item()
            max_err[name] = max(max_err[name], err)
        say("kernels", f"B={bb} N={n} L={length} bf16 mask_false={int((~mask).sum())}: "
            "gather and scatter equal their plain versions bit for bit")
    if not on_card:
        return []

    # times at the main path's shape: all rows unmasked, as expansion sees
    src, idx, rows, mask = _row_case(b, n, length, dev, gen, False)
    ar = torch.arange(b, device=dev)
    dst = src.clone()
    g_ms = time_ms(lambda: R.gather_rows(src, idx), 200)
    g_plain = time_ms(lambda: R._gather_rows_plain(src, idx), 200)
    g_lib = time_ms(lambda: src[ar, idx], 200)
    s_ms = time_ms(lambda: R.scatter_rows(dst, idx, rows, mask), 200)
    s_plain = time_ms(lambda: R._scatter_rows_plain(dst, idx, rows, mask), 50)
    # every row unmasked, every idx in range: index_put_ is the same store
    s_lib = time_ms(lambda: dst.index_put_((ar, idx.long()), rows), 200)
    row_bytes = length * src.element_size()
    g_bytes = 2 * b * row_bytes + 4 * b
    s_bytes = 2 * int(mask.sum()) * row_bytes + 5 * b
    bound = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3  # noqa: E731
    say("kernels", f"gather {g_ms * 1e3:.2f}us (plain {g_plain * 1e3:.2f}us, "
        f"src[ar, idx] {g_lib * 1e3:.2f}us, bound {bound(g_bytes) * 1e3:.2f}us); "
        f"scatter {s_ms * 1e3:.2f}us (plain {s_plain * 1e3:.2f}us, "
        f"index_put_ {s_lib * 1e3:.2f}us, bound {bound(s_bytes) * 1e3:.2f}us)")
    return [
        {"name": "gather_rows", "route": "cuda",
         "source": "die_e_tpu_torch/ops/csrc/rows.cu",
         "replaces": "die_e_tpu/ops/rows.py:50", "launches": 0,
         "max_abs_err": max_err["gather_rows"], "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": bound(g_bytes), "bound_by": "bytes", "library_ms": g_lib},
        {"name": "scatter_rows", "route": "cuda",
         "source": "die_e_tpu_torch/ops/csrc/rows.cu",
         "replaces": "die_e_tpu/ops/rows.py:110", "launches": 0,
         "max_abs_err": max_err["scatter_rows"], "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": bound(s_bytes), "bound_by": "bytes", "library_ms": s_lib},
    ]


def _dyadic_eval(num_actions):
    """A deterministic eval_fn whose policies are multiples of 1/1024, so
    that sums are exact in any order and a search is reproducible bit for
    bit on any device."""
    import torch

    def fn(obs):
        b = obs.shape[0]
        w = torch.arange(obs[0].numel(), device=obs.device) % 7 + 1
        s = (obs.reshape(b, -1) * w).sum(-1).to(torch.int64)
        k = (s[:, None] + torch.arange(num_actions, device=obs.device)) % 8 + 1
        return k.float() / 1024.0, (((s % 17) - 8).float() / 16.0)[:, None]

    return fn


def _random_states(env_mod, b, plies, dev, seed):
    """States from ``plies`` uniformly random legal moves of ``b`` games."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    states = env_mod.init(torch.randint(0, 2 ** 31 - 1, (b,), generator=gen, device=dev),
                          device=dev)
    for _ in range(plies):
        legal = env_mod.legal_mask(states).float()
        action = torch.multinomial(legal, 1, generator=gen)[:, 0]
        states = env_mod.step(states, action)
    return states


def phase_reference(dev, spec_full, games, iterations, seed) -> None:
    """The port on ``dev`` against the port on the CPU, on small inputs."""
    import torch

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.envs.base import map_state
    from die_e_tpu_torch.nets.resnet import forward, make_net
    from die_e_tpu_torch.search.alpha import alpha_search

    cpu = torch.device("cpu")
    states = _random_states(bg, 64, 12, dev, seed)
    states_cpu = map_state(lambda t: t.cpu(), states)
    if not torch.equal(bg.legal_mask(states).cpu(), bg.legal_mask(states_cpu)):
        raise AssertionError("legal_mask differs between the device and the cpu")
    small = map_state(lambda t: t[:8], states)
    small_cpu = map_state(lambda t: t[:8], states_cpu)
    fn = _dyadic_eval(bg.NUM_ACTIONS)
    kw = dict(iterations=16, c=2.0, dirichlet_epsilon=0.0, negamax=True)
    r_dev = alpha_search(bg.ENV, fn, small, torch.Generator(device=dev).manual_seed(1), **kw)
    r_cpu = alpha_search(bg.ENV, fn, small_cpu, torch.Generator().manual_seed(1), **kw)
    for f in dataclasses.fields(r_dev.tree):
        a, b_ = getattr(r_dev.tree, f.name), getattr(r_cpu.tree, f.name)
        if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b_):
            raise AssertionError(f"search tree field {f.name} differs from the cpu's")
    if not torch.equal(r_dev.visit_probs.cpu(), r_cpu.visit_probs):
        raise AssertionError("search visit_probs differ from the cpu's")
    spec_small = dataclasses.replace(spec_full, n_filters=32, n_res_blocks=2)
    net_dev, net_cpu = make_net(spec_small, seed, dev), make_net(spec_small, seed, cpu)
    obs = bg.observe(states)
    p_dev, v_dev = forward(net_dev, obs, softmax_policy=False)
    p_cpu, v_cpu = forward(net_cpu, obs.cpu(), softmax_policy=False)
    err = max((p_dev.cpu() - p_cpu).abs().max().item(), (v_dev.cpu() - v_cpu).abs().max().item())
    tol = 5e-2  # TF32 convolutions and matmuls on the card, f32 on the cpu
    if not err <= tol:
        raise AssertionError(f"ResNet on the device differs from the cpu by {err} > {tol}")
    say("reference", "legal_mask (64 states) and a 16-simulation search (8 games) equal "
        f"the cpu's bit for bit; 32x2 ResNet max |err| {err:.2e} <= {tol} (TF32)")

    if dev.type != "cuda":
        return
    # what one search iteration's parts cost at full width
    big = _random_states(bg, games, 12, dev, seed + 1)
    net = make_net(spec_full, seed, dev)
    obs = bg.observe(big)
    fwd = time_ms(lambda: forward(net, obs), 10, warmup=3)
    msk = time_ms(lambda: bg.legal_mask(big), 10, warmup=3)
    act = torch.full((games,), bg.NOOP_ACTION, device=dev)
    stp = time_ms(lambda: bg.step(big, act), 20)
    say("reference", f"at B={games}: ResNet {spec_full.n_filters}x{spec_full.n_res_blocks} "
        f"forward {fwd:.3f} ms, legal_mask {msk:.3f} ms, step {stp:.3f} ms")


def phase_self_play(dev, cfg, spec, games, iterations, rounds, seed) -> dict:
    import numpy as np
    import torch

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.nets.resnet import forward, make_net
    from die_e_tpu_torch.ops import rows as R
    from die_e_tpu_torch.train.self_play import trajectory_to_memory, self_play

    env = dataclasses.replace(bg.ENV, spec=spec)
    net = make_net(spec, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = cfg.mcts
    say("self-play", f"B={games} iterations={iterations} c={m.c} negamax={m.negamax} "
        f"net={spec.n_filters}x{spec.n_res_blocks} A={spec.num_actions} "
        f"rounds={rounds} (cut from round limit {m.simulate_round_limit})")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    R.reset_launches()
    t0 = time.perf_counter()
    traj = self_play(
        env, lambda obs: forward(net, obs), gen, batch_size=games,
        iterations=iterations, c=m.c, dirichlet_alpha=m.dirichlet_alpha,
        dirichlet_epsilon=m.dirichlet_epsilon,
        temperature=cfg.alphazero.temperature, round_limit=rounds,
        negamax=m.negamax, device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(R.launches)

    # the records: shapes, finite values, normalized visit rows
    t = traj.obs.shape[0]
    if t != rounds or tuple(traj.obs.shape[1:]) != (games, *spec.obs_shape):
        raise AssertionError(f"obs shape {tuple(traj.obs.shape)}")
    if not bool(torch.isfinite(traj.obs).all()):
        raise AssertionError("non-finite observations")
    if not bool(((traj.player == 1) | (traj.player == -1)).all()):
        raise AssertionError("players outside {-1, +1}")
    obs, ps, outcome = trajectory_to_memory(traj, cfg.alphazero.temperature)
    q = traj.probs.cpu().numpy().astype(np.int64).sum(-1)
    valid = traj.valid.cpu().numpy()
    if valid.sum() == 0 or np.abs(q[valid] - 65535).max() > spec.num_actions:
        raise AssertionError("visit rows of valid fragments do not sum to 1")
    if not np.isfinite(ps).all() or len(obs) != valid.sum():
        raise AssertionError("memory extraction failed")
    sims = t * iterations * games
    depth = traj.levels / (t * iterations)
    say("self-play", f"{t} rounds in {wall:.2f}s: {sims / wall:.0f} simulations/s, "
        f"mean descent depth {depth:.3f} levels, {int(valid.sum())} fragments, "
        f"launches gather={launches['gather_rows']} scatter={launches['scatter_rows']}")
    if dev.type == "cuda":
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"the main path launched {k} no time")
        want = {"gather_rows": traj.levels,
                "scatter_rows": traj.levels + t * (iterations + 1)}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != expected {want}")
    return launches


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (use --device cpu to rehearse)",
              file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from die_e_tpu_torch.core.config import load_config
        from die_e_tpu_torch.core.device import resolve_device
        from die_e_tpu_torch.envs import backgammon as bg
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr, flush=True)
        return 2

    dev = resolve_device("cuda:0" if args.device == "cuda" else "cpu")
    cfg = load_config(CONFIG)
    games = args.games or cfg.alphazero.num_self_play_batches
    iterations = args.iterations or cfg.mcts.iterations
    spec = dataclasses.replace(
        bg.SPEC,
        n_filters=args.filters or bg.SPEC.n_filters,
        n_res_blocks=args.blocks if args.blocks is not None else bg.SPEC.n_res_blocks,
    )
    from die_e_tpu_torch.ops.rows import pad_actions

    device = phase_device(dev)
    check_budget("device")
    phase_build(dev)
    check_budget("build")
    kernels = phase_kernels(dev, games, iterations + 1, pad_actions(spec.num_actions),
                            args.seed)
    check_budget("kernels")
    phase_reference(dev, spec, games, iterations, args.seed)
    check_budget("reference")
    launches = phase_self_play(dev, cfg, spec, games, iterations, ROUNDS, args.seed)
    check_budget("self-play")
    if dev.type != "cuda":
        say("done", "cpu rehearsal passed (no device numbers, no result line)")
        return 0
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
