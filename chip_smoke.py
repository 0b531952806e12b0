#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``die_e_tpu_torch``) on one NVIDIA GPU.

Phases, each reported on one flushed line with the elapsed seconds:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: the port's CUDA sources, one ``nvcc`` call each, with the
   ``-Xptxas -v`` register and shared-memory lines;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the self-play search's shape ([1024, 101, 2048] bf16),
   at B = 1000, at the gate arena's B = 100 and the mcts arena's B = 400,
   all three with false mask rows, an idx at N-1 and idx out of range, and
   at ``get_next_move``'s B = 1; then
   each kernel's time, the plain version's and, where one PyTorch call
   computes the same function, that call's, with CUDA events;
4. reference: the port on the card against the port on the CPU on small
   inputs (legal masks, a PUCT search, a pure-rollout search without
   playouts in both selection modes and a one-game ``get_next_move``
   search exactly, ``legal_single`` over the 26 digits against
   ``legal_digits`` for 60 seeded positions x 6 dice x both players
   exactly, the ResNet and one training step, with TF32 off for that step,
   within stated tolerances), and a breakdown of one search iteration's
   parts at full width;
5. self-play: ``train/self_play.py::self_play`` at the full width of
   ``configs/bg_full.toml`` (1024 games, 100 simulations, the 256x19
   ResNet, A = 1352) for 2 rounds (the one cut), with both kernels' launch
   counts, which must be above 0 and equal what the search's levels
   predict;
5a. bf16: the bf16 inference policy (``DIE_E_BF16=1``) on that phase's
   net and last states: the bf16 forward's softmax and value within 0.05
   of the f32 (TF32) forward's at B = 1024, both forwards' times with
   CUDA events beside their FLOPs and the TF32 and bf16 peaks, then
   ``self_play`` for 2 rounds with ``net_eval_fn(net, compute_dtype(dev))``,
   its simulations/s beside the f32 phase's and both kernels' launches as
   its search predicts, then both kernels bit for bit at its shape;
6. learn: the main path, the port's CLI ``learn`` on that config at full
   width (1024 games, 100 simulations, 256x19, batches of 256, 4 epochs),
   cut to 2 learn iterations of 1 self-play run of 2 rounds each and a
   100-game gate arena of 2 rounds, into a fresh directory under
   ``build/``; then ``learn --resume`` with a third iteration.  It checks
   the gate's verdicts, finite losses, the artifacts, that the restored
   ``latest_state`` gives the trained net's forward bit for bit, and each
   kernel's launches on the self-play and the arena path; it prints the
   wall time of each stage, the train step's time and TF32 share, and the
   peak device memory;
6a. bf16: the port's CLI ``play -1 model -2 random`` under
   ``DIE_E_BF16=1`` on the learn phase's ``best`` (100 games, cut to 2
   rounds): the model's ``net_eval_fn`` gets bf16, the tally adds up, the
   launches are what the search predicts, both kernels bit for bit at the
   arena's shape;
6b. bn-probe: the port's ``bn_padding_probe`` on the learn phase's
   ``best`` and its last ``memory.npz`` at the script's defaults (batch
   32, 3 steps, 144 rows): every number finite and the arms apart
   (``rel_params_delta > 0``); it prints the probe's JSON line;
7. mcts: the port's CLI ``play -1 mcts -2 random -o DIR`` on that config
   at full width (400 games, 100 UCB1 iterations a move, c = 2, A = 1352,
   tree capacity 101), cut to 2 arena rounds and playouts of at most 4
   steps, into a fresh directory under ``build/``; then ``replay
   --no-wait`` of one recorded game.  It checks the tally, the 400
   records and their winners, the replay's turns and last board, and each
   kernel's launches against what the searches predict; it prints the
   wall time, seconds per move, iterations per second and peak device
   memory;
8. compaction: tic-tac-toe self-play with live-game compaction (1024
   games at tic-tac-toe's own width, 64x4, the config's 100 simulations,
   round limit 9, so every game ends and the batch shrinks down the
   ladder; min_batch 128), then the same without compaction for the wall
   time; then the CLI's ``play -1 mcts -2 random --compact-arena -o`` on
   1024 tic-tac-toe games (min_batch 64).  It checks that every game
   ended, that each game's fragments are its moves at its own game id
   with the winner the player of its last move, that the tallies add up,
   that every record replays to its winner, and each kernel's launches
   against what the searches predict; then both kernels bit for bit at
   every batch they launched on; it prints the batches visited;
9. learn2: the port's CLI ``learn`` as 2 processes on this one card
   (gloo), joined by ``--coordinator/--num-processes/--process-id``, at
   full width (1024 games, 512 a process, 100 simulations, 256x19,
   batches of 256), cut to 1 iteration of 1 self-play run of 2 rounds, 1
   epoch and the 100-game, 2-round gate on process 0, from the learn
   phase's ``best``.  Before it, each process runs a 2-process train step
   against one process's (32x2, batch 64, weight-0 rows in the second
   half, TF32 off).  It checks identical losses and fragment counts on
   both processes, that only process 0 gated and wrote, finite losses,
   each kernel's launches at B = 512 on both processes, and both kernels
   bit for bit at the shapes they launched on; it prints each process's
   wall time by stage and the data-parallel step's time;
10. ladder: the port's ``strength_ladder`` on the learn phase's ``best``
   at full width (256x19, 100 simulations a move), rungs random and
   mcts16 (4-step playouts), 32 games in one block, cut to 2 rounds (of
   300); then the same command again with its ``--resume-state``, which
   must play nothing and change no file;
11. elo: the port's ``elo_tournament`` between the learn phase's ``best``
   and ``model_1`` and the random anchor, 16 games a pair, cut to 2
   rounds; then again on its cached matches, which must play nothing,
   load no model and give identical ratings;
12. ttt-learn: the port's ``ttt_learning_check`` cut to 2 learn
   iterations (of 24) of 1 self-play run of 256 games (64 simulations, a
   128-game gate, the 400-game final arena against random); it prints the
   non-loss rate without gating on it;
13. bg-demo: the port's ``bg_learning_demo`` at full width cut to 2 learn
   iterations of 2 self-play rounds, so that the second plays the 64-game
   gate, and to 2 rounds of gate and final arena;
14. parity: the port's ``parity_sweep``, 2048 seeded backgammon games on
   the card played to their end (at most 1500 steps) against the C++
   oracle, zero mismatches;
   in phases 10-13 each match's launches are set to 0 just before it and
   read just after, and must equal what its PUCT and pure-rollout
   searches predict; both kernels are then held bit for bit at every
   shape the phase launched them on;
15. the kernel table as one JSON line (``launches`` summed over every
   path, ``launches_by_path`` by path, the bf16 paths as ``bf16_self_play``
   and ``bf16_cli_arena``), then the result line
   ``{"ok": true, "device": {...}}``.

Any failed phase makes the script exit non-zero without the result line;
so does a missing card and a run over the time budget.  Weights are random,
made from ``--seed``; the script writes only into the ignored ``build/``.
The card's machine has one card, so NCCL between cards is not exercised
here.

Usage (from the root of a checkout):

    python3 chip_smoke.py                       # on the card, as above
    python3 chip_smoke.py --device cpu --games 4 --iterations 4 \\
        --filters 8 --blocks 1                  # CPU rehearsal, no result
        [--phases port|strength|learning]       # ... of phases 1-9, 6 and 10-11, or 12-14

A CPU rehearsal forces the bf16 phase's bf16 through the explicit dtype
(``compute_dtype`` is f32 off the card); its CLI step runs at the f32 that
``compute_dtype`` gives there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 600.0      # the whole run, build included
CONFIG = os.path.join(ROOT, "configs", "bg_full.toml")
ROUNDS = 2            # the one cut: self-play rounds (of the config's round limit)
# a CPU rehearsal's parts (the card runs "all"): the port's phases 1-9; the
# learn phase, whose checkpoints the ladder and the tournament play, and
# those two; the learning checks and the parity sweep
PARTS = {"all": ("port", "learn", "ladder", "elo", "ttt-learn", "bg-demo", "parity"),
         "port": ("port", "learn"), "strength": ("learn", "ladder", "elo"),
         "learning": ("ttt-learn", "bg-demo", "parity")}
# the learn phase's cuts of configs/bg_full.toml (widths stay as they are)
LEARN_CUTS = {"learn_iterations": 2, "self_play_iterations": 1,
              "simulate_round_limit": 2, "arena_num_games": 100,
              "arena_gate_block": 100, "arena_round_limit": 2}
# the mcts phase's cuts of configs/bg_full.toml: 2 arena rounds (of 300) and
# playouts of at most 4 steps (of 300)
MCTS_CUTS = {"arena_round_limit": 2, "simulate_round_limit": 4}
# the 2-process learn phase's cuts: one iteration of the learn phase's,
# and 1 epoch (of 4): 64 data-parallel steps
LEARN2_CUTS = {"learn_iterations": 1, "self_play_iterations": 1, "num_epochs": 1,
               "simulate_round_limit": 2, "arena_num_games": 100,
               "arena_gate_block": 100, "arena_round_limit": 2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
TF32_FLOP_PER_S = 495e12   # H100 SXM dense TF32, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
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
    # a CPU rehearsal in parts: phases 1-9, the learn phase and 10-11, or 12-14
    p.add_argument("--phases", default="all", choices=sorted(PARTS))
    # one process of the 2-process learn phase (the script starts these)
    p.add_argument("--rank-worker", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--run-dir", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _spec(args, game=None):
    """A game's spec (backgammon's by default), at a CPU rehearsal's
    smaller width if asked."""
    from die_e_tpu_torch.envs import backgammon as bg

    spec = (game or bg).SPEC
    return dataclasses.replace(
        spec,
        n_filters=args.filters or spec.n_filters,
        n_res_blocks=args.blocks if args.blocks is not None else spec.n_res_blocks,
    )


@contextlib.contextmanager
def _game_at(spec, game=None):
    """A game's module (backgammon's by default), which the CLI and the
    scripts read, with ``spec`` in it for the block: a CPU rehearsal's
    smaller net; nothing changes at full width."""
    from die_e_tpu_torch.envs import backgammon as bg

    game = game or bg
    saved = game.SPEC, game.ENV
    game.SPEC, game.ENV = spec, dataclasses.replace(game.ENV, spec=spec)
    try:
        yield
    finally:
        game.SPEC, game.ENV = saved


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


def _row_check(dev, gen, b, n, length, false_rows, max_err) -> int:
    """Both kernels against their plain versions, bit for bit, on one
    ``_row_case``; raises on a difference, keeps the largest |err| by
    kernel in ``max_err`` and returns the count of false mask rows."""
    import torch

    from die_e_tpu_torch.ops import rows as R

    src, idx, rows, mask = _row_case(b, n, length, dev, gen, false_rows)
    pairs = (("gather_rows", R.gather_rows(src, idx), R._gather_rows_plain(src, idx)),
             ("scatter_rows", R.scatter_rows(src.clone(), idx, rows, mask),
              R._scatter_rows_plain(src, idx, rows, mask)))
    _sync(dev)
    for name, x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"{name} differs from its plain version at [{b}, {n}, {length}]")
        max_err[name] = max(max_err[name], (x.float() - y.float()).abs().max().item())
    return int((~mask).sum())


def phase_kernels(dev, b, n, length, mcts_games, seed) -> list:
    """Each kernel against its plain version, bit for bit; then times."""
    import torch

    from die_e_tpu_torch.ops import rows as R

    gen = torch.Generator(device=dev).manual_seed(seed)
    on_card = dev.type == "cuda"
    max_err = {"gather_rows": 0.0, "scatter_rows": 0.0}
    # the self-play search's batch; a batch with false mask rows (games
    # whose root is terminal); the gate arena's dual search and the mcts
    # arena's pure-rollout search, whose done games give false mask rows;
    # get_next_move's one game
    cases = [(b, False), (b - 24 if b >= 32 else b + 3, True),
             (LEARN_CUTS["arena_gate_block"], True), (mcts_games, True), (1, False)]
    for bb, false_rows in cases:
        n_false = _row_check(dev, gen, bb, n, length, false_rows, max_err)
        say("kernels", f"B={bb} N={n} L={length} bf16 mask_false={n_false}: "
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


def _assert_trees_equal(what, t_dev, t_cpu) -> None:
    import torch

    for f in dataclasses.fields(t_dev):
        a, b_ = getattr(t_dev, f.name), getattr(t_cpu, f.name)
        if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b_):
            raise AssertionError(f"{what} tree field {f.name} differs from the cpu's")


def _simple_search_reference(dev, states, states_cpu, seed) -> None:
    """The pure-rollout search without playouts (it then draws nothing) on
    the device against the cpu: every tree field, and the action and visit
    probabilities in both selection modes, bit for bit."""
    import torch

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.search import simple

    iterations = 32
    out = {}
    for d, s in ((dev, states), (torch.device("cpu"), states_cpu)):
        gen = torch.Generator(device=d).manual_seed(seed)
        out[d.type] = simple.simple_search_tree(bg.ENV, s, gen, iterations, 2.0, 0)
    (t_dev, levels), (t_cpu, _) = out[dev.type], out["cpu"]
    _assert_trees_equal("simple search", t_dev, t_cpu)
    for selection in simple.SELECTIONS:
        a_dev, p_dev = simple.simple_search_select(bg.ENV, t_dev, selection)
        a_cpu, p_cpu = simple.simple_search_select(bg.ENV, t_cpu, selection)
        if not (torch.equal(a_dev.cpu(), a_cpu) and torch.equal(p_dev.cpu(), p_cpu)):
            raise AssertionError(f"simple search {selection} action or probs differ")
    say("reference", f"a {iterations}-iteration pure-rollout search ({states.board.shape[0]} "
        f"games, no playout step, {levels} descent levels) equals the cpu's bit for bit: "
        "every tree field, and action and visit probabilities for most_visits and win_pct")


def _simple_search_playouts(dev, seed) -> None:
    """The pure-rollout search with playouts on the device, on tic-tac-toe
    positions with one forced move (16 games each): an immediate win for
    x, and o's block of x's threat.  This holds what only a playout runs:
    the legal draws, the freezing of finished games, the sign of a
    playout's value against the root player and its backup through UCB1.
    The draws are random, so a rare miss is allowed: at most 2 of the 32
    games may choose another move."""
    import torch

    from die_e_tpu_torch.envs import tictactoe as ttt
    from die_e_tpu_torch.search import simple

    n = 16
    boards = [[-1, -1, 0, 1, 1, 0, 0, 0, 0]] * n + [[-1, -1, 0, 1, 0, 0, 0, 0, 0]] * n
    states = ttt.TttState(board=torch.tensor(boards, dtype=torch.int32, device=dev),
                          player=torch.tensor([-1] * n + [1] * n, dtype=torch.int32,
                                              device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    action, _ = simple.simple_search(ttt.ENV, states, gen, iterations=200, c=2.0,
                                     simulate_round_limit=9)
    action = action.cpu()
    wins, blocks = int((action[:n] == 2).sum()), int((action[n:] == 2).sum())
    if wins + blocks < 2 * n - 2:
        raise AssertionError(f"the search with playouts took the forced move in {wins}/{n} "
                             f"wins and {blocks}/{n} blocks")
    say("reference", f"a 200-iteration pure-rollout search with 9-step playouts takes the "
        f"immediate win in {wins}/{n} games and the block in {blocks}/{n}")


def _next_move_reference(dev, states, states_cpu, seed) -> None:
    """``get_next_move``'s one-game PUCT search (no Dirichlet noise, the
    dyadic eval_fn) on the device against the cpu: the same visit
    probabilities; each device's move lies in their support."""
    import torch

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.search import alpha

    fn = _dyadic_eval(bg.NUM_ACTIONS)
    kw = dict(iterations=32, c=2.0, dirichlet_epsilon=0.0, negamax=True)
    found = {}
    real = alpha.alpha_search

    def spy(env, eval_fn, one, gen, **k):
        found[one.board.device.type] = res = real(env, eval_fn, one, gen, **k)
        return res

    moves = []
    alpha.alpha_search = spy
    try:
        for g in (0, 5):
            for d, s in ((dev, states), (torch.device("cpu"), states_cpu)):
                gen = torch.Generator(device=d).manual_seed(seed)
                moves.append(alpha.get_next_move(bg.ENV, fn, s, gen, game=g, **kw))
            p_dev, p_cpu = found[dev.type].visit_probs.cpu(), found["cpu"].visit_probs
            if not torch.equal(p_dev, p_cpu):
                raise AssertionError(f"get_next_move's visit probabilities differ (game {g})")
            _assert_trees_equal("get_next_move", found[dev.type].tree, found["cpu"].tree)
            if not all(p_cpu[0, m] > 0 for m in moves[-2:]):
                raise AssertionError(f"get_next_move's moves {moves[-2:]} outside the support")
    finally:
        alpha.alpha_search = real
    say("reference", "get_next_move (one game, 32 simulations, no noise, dyadic eval) on "
        f"two games: visit probabilities and tree equal the cpu's, moves {moves} in the "
        "support")


def _random_positions(n, seed):
    """(board [n, 24], bar [n, 2]) int64 numpy arrays: 15 checkers a side
    split over the board, the bar and off, a third of the sides gathered in
    their home board (bear-off shapes), points held by one side only."""
    import numpy as np

    rng = np.random.default_rng(seed)
    board = np.zeros((n, 24), np.int64)
    bar = np.zeros((n, 2), np.int64)
    for i in range(n):
        for side, player in enumerate((-1, 1)):
            left = 15 - (int(rng.integers(0, 15)) if rng.random() < 0.3 else 0)
            bar[i, side] = min(left, int(rng.choice([0, 0, 0, 1, 2])))
            left -= bar[i, side]
            home = rng.random() < 0.35
            points = np.arange(6) if player < 0 else np.arange(18, 24)
            while left > 0:
                q = int(rng.choice(points)) if home else int(rng.integers(0, 24))
                if board[i, q] * player < 0:
                    continue  # held by the other side
                add = min(left, int(rng.integers(1, 6)))
                board[i, q] += add * player
                left -= add
    return board, bar


def _legal_single_reference(dev, seed) -> None:
    """``legal_single`` over the 26 digits equals ``legal_digits`` on the
    device, and the cpu's, exactly: 60 seeded positions x 6 dice x both
    players."""
    import numpy as np
    import torch

    from die_e_tpu_torch.envs import backgammon as bg

    board, bar = _random_positions(60, seed)
    rows = [torch.from_numpy(x) for x in (
        np.repeat(board, 12, 0), np.repeat(bar, 12, 0),
        np.tile(np.repeat([-1, 1], 6), 60), np.tile(np.arange(1, 7), 120))]
    out = {}
    for d in (dev, torch.device("cpu")):
        b, br, p, die = (x.to(d) for x in rows)
        single = bg.legal_single(b[:, None], br[:, None], p[:, None], die[:, None],
                                 torch.arange(26, device=d)[None])
        digits = bg.legal_digits(b, br, p, die)
        if not torch.equal(single, digits):
            raise AssertionError(f"legal_single differs from legal_digits on {d.type} at rows "
                                 f"{torch.nonzero((single != digits).any(-1))[:8, 0].tolist()}")
        out[d.type] = single.cpu()
    if not torch.equal(out[dev.type], out["cpu"]):
        raise AssertionError("legal_single on the device differs from the cpu's")
    say("reference", f"legal_single over the 26 digits equals legal_digits for 60 seeded "
        f"positions x 6 dice x both players ({int(out['cpu'].sum())} legal of "
        f"{out['cpu'].numel()}; {int((bar > 0).any(1).sum())} positions with a bar checker), "
        "on the device and on the cpu, exactly")


def _set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _adam_first_step(p0, m, v, group) -> "torch.Tensor":
    """The parameter after Adam's first step from its moments, in float64
    (the reference for both devices' optimizer paths)."""
    b1, b2 = group["betas"]
    return (p0.double() - group["lr"] / (1 - b1) * m.double()
            / (v.double().sqrt() / (1 - b2) ** 0.5 + group["eps"]))


def _step_batch(spec, obs, seed):
    """(obs, ps, outcome, weight) on the CPU for one train step: Dirichlet
    visit rows, outcomes in {-1, 0, 1}, the last 5 rows at weight 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = obs.shape[0]
    ps = rng.dirichlet(np.full(spec.num_actions, 0.05), b).astype(np.float32)
    outcome = rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32)
    weight = np.ones(b, np.float32)
    weight[-5:] = 0.0
    return (obs.cpu(), *(torch.from_numpy(x) for x in (ps, outcome, weight)))


def _step_outputs(st, loss, p0) -> dict:
    """What one ``train_step`` left in ``st``, on the CPU, and how far each
    parameter is from Adam's first step from its own moments (float64)."""
    group = st.opt.param_groups[0]
    o = {
        "loss": float(loss),
        "grads": {k: p.grad.cpu() for k, p in st.net.named_parameters()},
        "running stats": {k: v.cpu() for k, v in st.net.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))},
        "exp_avg": {k: st.opt.state[p]["exp_avg"].cpu() for k, p in st.net.named_parameters()},
        "exp_avg_sq": {k: st.opt.state[p]["exp_avg_sq"].cpu()
                       for k, p in st.net.named_parameters()},
        "params": {k: p.detach().cpu() for k, p in st.net.named_parameters()},
    }
    o["adam update"] = max(float((o["params"][k].double() - _adam_first_step(
        p0[k], o["exp_avg"][k], o["exp_avg_sq"][k], group)).abs().max()) for k in p0)
    return o


def _step_errors(o_d, o_c, p0, group) -> dict:
    """How far one step's outputs ``o_d`` are from the reference's ``o_c``:
    the loss relative, gradients and moments relative to the reference's
    largest value, running statistics absolute, Adam's update absolute
    (the larger of the two), and the parameters' difference over what the
    gradients' difference allows: Adam's first update is lr * g / (|g| +
    eps) elementwise (coupled decay inside g), so gradients that differ by
    |dg| move a parameter apart by at most 2 lr |dg| / (|g| + eps), plus
    1e-6 for float32 rounding."""

    def rel(key):  # relative to the largest value of the reference's
        scale = max(float(x.abs().max()) for x in o_c[key].values())
        return max(float((o_d[key][k] - x).abs().max()) for k, x in o_c[key].items()) / scale

    lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
    param_ratio = max(float(((o_d["params"][k] - o_c["params"][k]).abs() / (
        1e-6 + 2 * lr * (o_d["grads"][k] - g).abs()
        / ((g + wd * p0[k]).abs() + eps))).max()) for k, g in o_c["grads"].items())
    return {
        "loss": abs(o_d["loss"] - o_c["loss"]) / max(1.0, abs(o_c["loss"])),
        "grads": rel("grads"),
        "running stats": max(float((o_d["running stats"][k] - v).abs().max())
                             for k, v in o_c["running stats"].items()),
        "exp_avg": rel("exp_avg"),
        "exp_avg_sq": rel("exp_avg_sq"),
        "adam update": max(o_d["adam update"], o_c["adam update"]),
        "params": param_ratio,
    }


def _check_errors(what, errs, tol) -> str:
    for k, e in errs.items():
        if not e <= tol[k]:
            raise AssertionError(f"{what}: {k} differs by {e:.3e} > {tol[k]}")
    return ", ".join(f"{k} err {e:.2e} <= {tol[k]}" for k, e in errs.items())


STEP_ERRORS_DOC = ("(loss relative; grads and moments relative to the reference's largest; "
                   "stats absolute; adam update: each side's parameters against Adam's first "
                   "step from its own moments in float64, absolute; params: the parameters' "
                   "difference over 1e-6 + 2 lr |dg| / (|g| + eps), elementwise)")


def _train_step_reference(dev, spec, obs, seed) -> None:
    """One ``train_step`` on ``dev`` against the CPU, same weights and
    batch, float32 with TF32 off on the card for this comparison only: the
    loss, gradients, BatchNorm running statistics, Adam's moments and the
    parameters after the step."""
    import torch

    from die_e_tpu_torch.train.learner import create_train_state, train_step

    batch = _step_batch(spec, obs, seed)
    out = {}
    try:
        for d in {dev, torch.device("cpu")}:
            st = create_train_state(spec, seed, device=d)
            _set_tf32(False)  # after resolve_device, which turns TF32 on
            p0 = {k: p.detach().cpu().clone() for k, p in st.net.named_parameters()}
            _, m = train_step(st, *(x.to(d) for x in batch))
            out[d.type] = _step_outputs(st, m["loss"].item(), p0)
            group = st.opt.param_groups[0]
    finally:
        _set_tf32(dev.type == "cuda")
    errs = _step_errors(out[dev.type], out["cpu"], p0, group)
    # float32 on both sides, sums in other orders (cuDNN's algorithms);
    # exp_avg_sq holds g^2, so twice the gradients' relative error
    tol = {"loss": 1e-4, "grads": 1e-4, "running stats": 1e-4, "exp_avg": 1e-4,
           "exp_avg_sq": 2e-4, "adam update": 1e-6, "params": 1.0}
    line = _check_errors("train step against the cpu", errs, tol)
    say("reference", f"one train step ({spec.n_filters}x{spec.n_res_blocks}, batch "
        f"{obs.shape[0]}, TF32 off), {dev.type} against the cpu: {line} {STEP_ERRORS_DOC}")


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
    _assert_trees_equal("search", r_dev.tree, r_cpu.tree)
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
    _simple_search_reference(dev, small, small_cpu, seed)
    _simple_search_playouts(dev, seed)
    _next_move_reference(dev, states, states_cpu, seed)
    _legal_single_reference(dev, seed)
    _train_step_reference(dev, spec_small, obs, seed)

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


def _self_play_run(dev, cfg, spec, eval_fn, games, iterations, rounds, seed, path) -> dict:
    """``self_play`` with ``eval_fn`` for ``rounds`` rounds from ``seed``;
    checks the records and the kernels' launches against the search's
    levels; returns the trajectory, the wall time, simulations/s, and the
    launches and their shapes."""
    import numpy as np
    import torch

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.ops import rows as R
    from die_e_tpu_torch.train.self_play import trajectory_to_memory, self_play

    env = dataclasses.replace(bg.ENV, spec=spec)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = cfg.mcts
    _sync(dev)
    R.reset_launches()
    t0 = time.perf_counter()
    traj = self_play(
        env, eval_fn, gen, batch_size=games,
        iterations=iterations, c=m.c, dirichlet_alpha=m.dirichlet_alpha,
        dirichlet_epsilon=m.dirichlet_epsilon,
        temperature=cfg.alphazero.temperature, round_limit=rounds,
        negamax=m.negamax, device=dev,
    )
    _sync(dev)
    wall = time.perf_counter() - t0
    launches, shapes = dict(R.launches), collections.Counter(R.launch_shapes)

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
    _check_launches(dev, path, launches, _puct_launches(traj.levels, t, iterations))
    return {"traj": traj, "wall": wall, "sims_per_s": t * iterations * games / wall,
            "fragments": int(valid.sum()), "launches": launches, "shapes": shapes}


def phase_self_play(dev, cfg, spec, games, iterations, rounds, seed) -> dict:
    """Full-width self-play; returns its launches, its net, the last
    round's observations and its simulations/s."""
    from die_e_tpu_torch.nets.resnet import forward, make_net

    net = make_net(spec, seed, dev)
    m = cfg.mcts
    say("self-play", f"B={games} iterations={iterations} c={m.c} negamax={m.negamax} "
        f"net={spec.n_filters}x{spec.n_res_blocks} A={spec.num_actions} "
        f"rounds={rounds} (cut from round limit {m.simulate_round_limit})")
    run = _self_play_run(dev, cfg, spec, lambda obs: forward(net, obs), games, iterations,
                         rounds, seed, "self-play")
    traj, wall, launches = run["traj"], run["wall"], run["launches"]
    t = traj.obs.shape[0]
    say("self-play", f"{t} rounds in {wall:.2f}s: {run['sims_per_s']:.0f} simulations/s, "
        f"mean descent depth {traj.levels / (t * iterations):.3f} levels, "
        f"{run['fragments']} fragments, "
        f"launches gather={launches['gather_rows']} scatter={launches['scatter_rows']}")
    return {"launches": launches, "net": net, "obs": traj.obs[-1],
            "sims_per_s": run["sims_per_s"]}


@contextlib.contextmanager
def _bf16_env():
    """``DIE_E_BF16=1`` for the block, as a user sets it; unset after."""
    os.environ["DIE_E_BF16"] = "1"
    try:
        yield
    finally:
        os.environ.pop("DIE_E_BF16", None)


def phase_bf16(dev, cfg, spec, games, iterations, rounds, seed, sp, card):
    """The bf16 inference policy on the self-play phase's net and states:
    the bf16 forward against the f32 (TF32) one, both forwards' times, and
    ``self_play`` with ``net_eval_fn(net, compute_dtype(dev))`` under
    ``DIE_E_BF16=1``; returns the kernels' launches and their shapes."""
    import torch

    from die_e_tpu_torch.core.device import compute_dtype
    from die_e_tpu_torch.nets.resnet import forward
    from die_e_tpu_torch.train.learner import net_eval_fn

    net, obs = sp["net"], sp["obs"]
    with _bf16_env():
        # a CPU rehearsal, where compute_dtype is f32, forces bf16 explicitly
        dtype = compute_dtype(dev) if dev.type == "cuda" else torch.bfloat16
        if dtype != torch.bfloat16:
            raise AssertionError(f"compute_dtype under DIE_E_BF16=1 gave {dtype} on the card")
        p32, v32 = forward(net, obs)
        p16, v16 = forward(net, obs, dtype=dtype)
        if (p16.dtype, v16.dtype) != (torch.float32, torch.float32):
            raise AssertionError(f"bf16 forward returned {p16.dtype}, {v16.dtype}")
        err = max((p16 - p32).abs().max().item(), (v16 - v32).abs().max().item())
        tol = 0.05  # the JAX package's bf16-against-f32 tolerance (tests/test_resnet.py)
        if not err <= tol:
            raise AssertionError(f"bf16 forward differs from f32 by {err} > {tol}")
        say("bf16", f"compute_dtype under DIE_E_BF16=1: {dtype}"
            + ("" if dev.type == "cuda" else " (forced: compute_dtype is f32 on the cpu)")
            + f"; {spec.n_filters}x{spec.n_res_blocks} forward at B={obs.shape[0]}, "
            f"A={spec.num_actions}: bf16 softmax and value within {err:.3e} <= {tol} of "
            + ("f32 (TF32 convs and matmuls)" if dev.type == "cuda" else "f32"))
        if dev.type == "cuda":
            flops = _forward_flops(net) * obs.shape[0]
            ms = {torch.float32: [], dtype: []}
            for d in (torch.float32, dtype, dtype, torch.float32):  # in turns
                ms[d].append(time_ms(lambda d=d: forward(net, obs, dtype=d), 20, warmup=3))
            t32, t16 = min(ms[torch.float32]), min(ms[dtype])
            say("bf16", f"on {card}: forward f32/TF32 "
                + " / ".join(f"{t:.3f}" for t in ms[torch.float32]) + " ms, bf16 "
                + " / ".join(f"{t:.3f}" for t in ms[dtype])
                + f" ms (best {t32 / t16:.2f}x); {flops / 1e9:.1f} GFLOP (from the shapes): "
                f"{100 * flops / (t32 * 1e-3) / TF32_FLOP_PER_S:.1f}% of the 495 TFLOP/s TF32 "
                f"peak, {100 * flops / (t16 * 1e-3) / BF16_FLOP_PER_S:.1f}% of the 989 TFLOP/s "
                "bf16 peak")
        run = _self_play_run(dev, cfg, spec, net_eval_fn(net, dtype), games, iterations, rounds,
                             seed, "bf16_self_play")
    traj, launches = run["traj"], run["launches"]
    say("bf16", f"self_play with net_eval_fn(net, {dtype}): {traj.obs.shape[0]} rounds in "
        f"{run['wall']:.2f}s: {run['sims_per_s']:.0f} simulations/s (f32 in the self-play "
        f"phase: {sp['sims_per_s']:.0f}), {run['fragments']} fragments, launches "
        + _launch_line(launches, dev))
    return {"bf16_self_play": launches}, {"bf16_self_play": run["shapes"]}


def _puct_launches(levels, searches, iterations) -> dict:
    """The PUCT search's launches: one gather per descent level; one
    scatter per level (the taken-action mark) and per expansion (the root
    and one leaf per simulation)."""
    return {"gather_rows": levels, "scatter_rows": levels + searches * (iterations + 1)}


def _check_launches(dev, path, launches, want) -> None:
    """On the card each kernel ran, and as often as ``want`` predicts."""
    if dev.type != "cuda":
        return
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the {path} path launched {k} no time")
    if launches != want:
        raise AssertionError(f"{path} launch counts {launches} != expected {want}")


class _Taps:
    """Wrap functions of the port's modules for the learn phase: time each
    call (synchronised on the card), and for the two search paths set the
    kernels' launch counts to 0 just before the call, read them just after
    and check them against the search's levels.  Restores everything on
    exit."""

    def __init__(self, dev, iterations):
        self.dev, self.iterations = dev, iterations
        self.seconds: dict = {}
        self.launches = {"learn_self_play": {}, "learn_arena": {}}
        self.shapes = {"learn_self_play": collections.Counter(),
                       "learn_arena": collections.Counter()}
        self.steps = self.rows = 0
        self.result = None
        self._undo = []

    def _sync(self):
        _sync(self.dev)

    def _time(self, key, fn, *a, _sync=True, **kw):
        """``_sync=False`` for host-only work on another thread, which a
        device synchronise would make wait for the loop's device work."""
        if _sync:
            self._sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if _sync:
            self._sync()
        self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
        return out

    def _search_path(self, key, fn, levels_rounds, *a, **kw):
        from die_e_tpu_torch.ops import rows as R

        R.reset_launches()
        out = self._time(key, fn, *a, **kw)
        got = dict(R.launches)
        _check_launches(self.dev, key, got, _puct_launches(*levels_rounds(out), self.iterations))
        for k, v in got.items():
            self.launches[key][k] = self.launches[key].get(k, 0) + v
        self.shapes[key].update(R.launch_shapes)
        return out

    def _wrap(self, mod, name, wrapper):
        real = getattr(mod, name)
        setattr(mod, name, lambda *a, **kw: wrapper(real, *a, **kw))
        self._undo.append((mod, name, real))

    def __enter__(self):
        from die_e_tpu_torch.train import checkpoint, gating
        from die_e_tpu_torch.train import learn as learn_mod

        def epoch(real, state, data, batch_size, *a, **kw):
            self.steps += data.padded_rows // batch_size
            self.rows += data.n
            return self._time("train", real, state, data, batch_size, *a, **kw)

        def learn(real, *a, **kw):
            self.result = real(*a, **kw)
            return self.result

        self._wrap(learn_mod, "self_play_from_states", lambda real, *a, **kw: self._search_path(
            "learn_self_play", real, lambda tr: (tr.levels, tr.obs.shape[0]), *a, **kw))
        self._wrap(gating, "play", lambda real, *a, **kw: self._search_path(
            "learn_arena", real, lambda r: (r.levels, r.rounds), *a, **kw))
        self._wrap(learn_mod, "train_epoch_device", epoch)
        self._wrap(learn_mod, "gate", lambda real, *a, **kw: self._time("gate", real, *a, **kw))
        self._wrap(checkpoint, "host_state",
                   lambda real, *a, **kw: self._time("checkpoint copy to host", real, *a, **kw))
        self._wrap(checkpoint, "_write", lambda real, *a, **kw: self._time(
            "checkpoint writes", real, *a, _sync=False, **kw))
        self._wrap(learn_mod, "learn", learn)
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)


def _forward_flops(net) -> int:
    """Multiply-adds x 2 of one sample's forward, from the layer shapes."""
    import torch

    h, w, _ = net.spec.obs_shape
    flops = 0
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            flops += 2 * m.in_channels * m.out_channels * m.kernel_size[0] * m.kernel_size[1] * h * w
        elif isinstance(m, torch.nn.Linear):
            flops += 2 * m.in_features * m.out_features
    return flops


def _learn_config(run_dir, games, iterations, learn_iterations) -> str:
    """configs/bg_full.toml with the learn phase's cuts (and, in a CPU
    rehearsal, its smaller game batch and simulation count)."""
    cuts = dict(LEARN_CUTS, learn_iterations=learn_iterations,
                num_self_play_batches=games, iterations=iterations)
    return _config_copy(os.path.join(run_dir, f"learn_{learn_iterations}.toml"), cuts)


def _config_copy(path, cuts) -> str:
    """Write configs/bg_full.toml with the keys of ``cuts`` replaced to
    ``path``."""
    lines = []
    for line in open(CONFIG).read().splitlines():
        key = line.split("=")[0].strip()
        if key in cuts:
            continue
        lines.append(line)
    lines += [f"{k} = {v}" for k, v in cuts.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_learn(dev, spec, games, iterations, seed):
    """The port's CLI ``learn``, then ``learn --resume``; returns the
    kernels' launches by path, their launch shapes and the run's
    directory."""
    import json as json_

    import numpy as np
    import torch

    from die_e_tpu_torch.cli import main as cli
    from die_e_tpu_torch.core.config import load_config
    from die_e_tpu_torch.nets.resnet import forward
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train.learner import create_train_state, train_step
    from die_e_tpu_torch.train.replay import load_training_data

    run_dir = os.path.join(ROOT, "build", f"learn-{os.getpid()}-{int(time.time())}")
    os.makedirs(run_dir)
    say("learn", f"configs/bg_full.toml at B={games} iterations={iterations} "
        f"net={spec.n_filters}x{spec.n_res_blocks}, cut to "
        + ", ".join(f"{k}={v}" for k, v in LEARN_CUTS.items()) + f"; in {run_dir}")
    jsonl = os.path.join(run_dir, "metrics.jsonl")
    argv = ["--device", dev.type, "--seed", str(seed), "-g", "backgammon",
            "--metrics-jsonl", jsonl]
    cwd = os.getcwd()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_game_at(spec))
        taps = stack.enter_context(_Taps(dev, iterations))
        stack.callback(os.chdir, cwd)
        os.chdir(run_dir)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cli.main(argv + ["-c", _learn_config(run_dir, games, iterations, 2), "learn"]) != 0:
            raise AssertionError("learn exited non-zero")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        trained = taps.result
        first = dict(taps.seconds), taps.steps, taps.rows
        mdir = os.path.join(run_dir, "models", "backgammon")

        # the committed latest_state, restored on the device, is the trained net
        restored = create_train_state(spec, seed + 1, device=dev)
        ckpt.restore_state(os.path.join(mdir, "latest_state"), restored)
        obs = torch.from_numpy(load_training_data(
            os.path.join(run_dir, "data", "backgammon",
                         os.listdir(os.path.join(run_dir, "data", "backgammon"))[0],
                         "lrn-1", "sp-0")).states[:256]).to(dev)
        for a, b in zip(forward(trained.net, obs), forward(restored.net, obs)):
            if not torch.equal(a, b):
                raise AssertionError("restored latest_state's forward differs from the trained net's")
        if restored.step != trained.step:
            raise AssertionError(f"restored step {restored.step} != trained {trained.step}")
        # Adam's step counts stay on the host, its moments go to the device
        for p in restored.net.parameters():
            st = restored.opt.state[p]
            if st["step"].device.type != "cpu" or st["exp_avg"].device != p.device:
                raise AssertionError("restored Adam state on the wrong device: step on "
                                     f"{st['step'].device}, exp_avg on {st['exp_avg'].device}")

        t1 = time.perf_counter()
        if cli.main(argv + ["-c", _learn_config(run_dir, games, iterations, 3),
                            "learn", "--resume"]) != 0:
            raise AssertionError("learn --resume exited non-zero")
        resume_wall = time.perf_counter() - t1

    events = [json_.loads(line) for line in open(jsonl)]
    starts = [e for e in events if e["event"] == "run_start"]
    gates = [e for e in events if e["event"] == "gate"]
    epochs = [e for e in events if e["event"] == "train_epoch"]
    if [e["start_iter"] for e in starts] != [0, 2] or starts[0]["run_id"] != starts[1]["run_id"]:
        raise AssertionError(f"run starts {starts}")
    if gates[0]["result"] != "no_best_promoted":
        raise AssertionError(f"iteration 0's gate: {gates[0]}")
    for g in gates[1:]:
        if (g["result"], g["draws"], g["games"]) != ("best_kept", 100, 100):
            raise AssertionError(f"a 2-round gate must keep best on 100 draws: {g}")
    if len(gates) != 3 or len(epochs) != 3 * 4 or not all(
            np.isfinite(e["loss"]) for e in epochs):
        raise AssertionError(f"gates {len(gates)}, epochs {epochs}")
    run_id = starts[0]["run_id"]
    for rel in ["models/backgammon/" + m for m in
                ("model_0", "model_1", "model_2", "best", "latest_state",
                 "latest_meta.json")] + [
            f"data/backgammon/run-{run_id}/lrn-{i}/sp-0/memory.npz" for i in range(3)]:
        if not os.path.exists(os.path.join(run_dir, rel)):
            raise AssertionError(f"missing {rel}")
    meta = json_.load(open(os.path.join(mdir, "latest_meta.json")))
    if meta != {"run_id": run_id, "next_learn_iter": 3}:
        raise AssertionError(f"resume cursor {meta}")

    secs, steps, rows = first
    bs = load_config(CONFIG).alphazero.training_batch_size
    losses = ", ".join(f"{e['loss']:.4f}" for e in epochs)
    say("learn", f"2 iterations in {wall:.2f}s; resume to iteration 2 in {resume_wall:.2f}s; "
        "gates: no_best_promoted, best_kept (100 draws), best_kept (100 draws); "
        f"losses {losses}; latest_state restored on the device gives the trained "
        "net's forward bit for bit, with Adam's moments on the device and its step "
        "counts on the host")
    say("learn", "first call's wall time by stage: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in secs.items())
        + f"; {steps} train steps, {steps / secs['train']:.1f} steps/s, "
        f"{steps * bs / secs['train']:.0f} samples/s incl. padding rows, "
        f"{rows / secs['train']:.0f} real samples/s"
        + (f"; peak device memory {peak / 2 ** 30:.3f} GiB" if peak is not None else ""))
    for path, counts in taps.launches.items():
        say("learn", f"{path}: launches over both calls " + ", ".join(
            f"{k}={v}" for k, v in counts.items())
            + (" (each call's counts equal what its search levels predict)"
               if dev.type == "cuda" else ""))

    if dev.type == "cuda":
        st = create_train_state(spec, seed, device=dev)
        data = load_training_data(os.path.join(
            run_dir, "data", "backgammon", f"run-{run_id}", "lrn-0", "sp-0"))
        batch = [torch.from_numpy(x[:bs]).to(dev) for x in (data.states, data.ps, data.outcomes)]
        w = torch.ones(bs, device=dev)
        ms = time_ms(lambda: train_step(st, *batch, w), 20, warmup=3)
        flops = 3 * _forward_flops(st.net) * bs
        say("learn", f"train step at batch {bs}: {ms:.3f} ms, {flops / 1e9:.1f} GFLOP "
            f"(3x the forward's, from the shapes): {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * flops / (ms * 1e-3) / TF32_FLOP_PER_S:.1f}% of the 495 TFLOP/s TF32 peak")
    return taps.launches, taps.shapes, run_dir


@contextlib.contextmanager
def _eval_dtypes():
    """The dtypes ``net_eval_fn`` is asked for in the block, in order."""
    from die_e_tpu_torch.train import learner

    seen, real = [], learner.net_eval_fn

    def spy(net, dtype=learner.COMPUTE_DTYPE):
        seen.append(dtype)
        return real(net, dtype)

    learner.net_eval_fn = spy
    try:
        yield seen
    finally:
        learner.net_eval_fn = real


def phase_bf16_cli(dev, spec, learn_dir, games, iterations, seed, card):
    """The port's CLI ``play -1 model -2 random`` under ``DIE_E_BF16=1`` on
    the learn phase's ``best``, cut to 2 arena rounds; returns the kernels'
    launches and their shapes."""
    import torch

    from die_e_tpu_torch.arena import versus
    from die_e_tpu_torch.cli import main as cli

    run_dir = _run_dir("bf16-cli")
    cuts = {"arena_round_limit": SCRIPT_ROUNDS, "iterations": iterations}
    cfg = _config_copy(os.path.join(run_dir, "play.toml"), cuts)
    best = os.path.join(learn_dir, "models", "backgammon", "best")
    say("bf16", f"DIE_E_BF16=1 CLI play -1 model -2 random on the learn phase's best (net "
        f"{spec.n_filters}x{spec.n_res_blocks}, {iterations} simulations a move), {games} games, "
        f"configs/bg_full.toml cut to {SCRIPT_ROUNDS} arena rounds (of 300); in {run_dir}")
    argv = ["--device", dev.type, "--seed", str(seed), "-g", "backgammon", "-c", cfg, "play",
            "-1", "model", "-2", "random", "--model1-path", best, "--num-games", str(games)]
    with _game_at(spec), _bf16_env(), _eval_dtypes() as dtypes, _MatchTaps(
            dev, lambda *a: "bf16_cli_arena", versus) as taps:
        rc, text, _ = _run_main(cli.main, argv)
    want = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if rc != 0 or dtypes != [want]:
        raise AssertionError(f"play rc {rc}, net_eval_fn dtypes {dtypes} (want [{want}]):\n{text}")
    tally = _tally(text)
    if tally["Number of Games"] != games or sum(
            tally[k] for k in ("Wins Player 1", "Wins Player 2", "Draws")) != games:
        raise AssertionError(f"the tally {tally} does not sum to {games}:\n{text}")
    ((_, res, wall),) = taps.matches
    say("bf16", f"the model's net_eval_fn got {dtypes[0]}; tally {tally['Wins Player 1']}/"
        f"{tally['Wins Player 2']}/{tally['Draws']} (model/random/draws) of {games}; on {card}: "
        f"{res.rounds} moves in {wall:.2f}s, {wall / max(res.rounds, 1):.3f} s a move; launches "
        + _launch_line(taps.launches["bf16_cli_arena"], dev))
    shutil.rmtree(run_dir)
    return taps.launches, taps.shapes


def phase_bn_probe(dev, spec, learn_dir, card) -> None:
    """The port's BatchNorm-padding probe on the learn phase's ``best`` and
    its own ``memory.npz`` (the last in sorted order), at the script's
    defaults (a CPU rehearsal's 8-row files take batch 2, 2 steps)."""
    from die_e_tpu_torch.scripts import bn_padding_probe as probe

    memory = os.path.join(learn_dir, "data", "backgammon", "run-*", "lrn-*", "sp-*",
                          "memory.npz")
    argv = ["--model-path", os.path.join(learn_dir, "models", "backgammon", "best"),
            "--memory", memory, "--device", dev.type]
    if dev.type != "cuda":
        argv += ["--batch", "2", "--steps", "2"]
    a = probe.build_parser().parse_args(argv)
    say("bn-probe", f"bn_padding_probe on the learn phase's best (net {spec.n_filters}x"
        f"{spec.n_res_blocks}) and its last memory.npz: batch {a.batch}, {a.steps} steps, "
        f"{probe.rows_needed(a.steps, a.batch)} rows, lr {a.lr}, wd {a.wd}")
    _sync(dev)
    t0 = time.perf_counter()
    with _game_at(spec):
        rc, text, _ = _run_main(probe.main, argv)
    _sync(dev)
    wall = time.perf_counter() - t0
    rows = _json_rows(text, "bn_padding_probe")
    keys = ("rel_batch_stats_delta", "rel_params_delta", "eval_loss_padded",
            "eval_loss_natural", "eval_loss_rel_delta")
    if rc != 0 or len(rows) != 1 or not all(math.isfinite(rows[0][k]) for k in keys) \
            or not rows[0]["rel_params_delta"] > 0:
        raise AssertionError(f"bn_padding_probe rc {rc}:\n{text}")
    print(json.dumps(rows[0]), flush=True)
    say("bn-probe", f"on {card}: {wall:.2f}s; every number finite, the arms differ "
        f"(rel_params_delta {rows[0]['rel_params_delta']:.3e} > 0)")


def phase_mcts(dev, games, iterations, seed, card) -> dict:
    """The port's CLI ``play -1 mcts -2 random -o DIR``, then ``replay
    --no-wait`` of one recorded game; returns the kernels' launches on the
    match.  ``card`` is the card's name and power limit, printed beside
    the times."""
    import io

    import torch

    from die_e_tpu_torch.arena import records, versus
    from die_e_tpu_torch.cli import main as cli
    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.ops import rows as R

    run_dir = os.path.join(ROOT, "build", f"mcts-{os.getpid()}-{int(time.time())}")
    games_dir = os.path.join(run_dir, "games")
    os.makedirs(run_dir)
    cfg = _config_copy(os.path.join(run_dir, "mcts.toml"), dict(MCTS_CUTS, iterations=iterations))
    say("mcts", f"configs/bg_full.toml, mcts against random, {games} games, {iterations} "
        f"UCB1 iterations a move (c = 2, tree capacity {iterations + 1}, A = {bg.NUM_ACTIONS}), "
        "cut to " + ", ".join(f"{k}={v}" for k, v in MCTS_CUTS.items())
        + f" (of 300 each); in {run_dir}")
    argv = ["--device", dev.type, "--seed", str(seed), "-g", "backgammon", "-c", cfg]
    taps = {}
    real_play, real_replay = versus.play, records.replay_game

    def play(*a, **kw):
        R.reset_launches()
        taps["result"] = real_play(*a, **kw)
        _sync(dev)
        taps["launches"] = dict(R.launches)
        return taps["result"]

    def replay(*a, **kw):
        taps["final"] = real_replay(*a, **kw)
        return taps["final"]

    out = io.StringIO()
    versus.play, records.replay_game = play, replay
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + ["play", "-1", "mcts", "-2", "random",
                                  "--num-games", str(games), "-o", games_dir])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        print(out.getvalue(), end="", flush=True)
        if rc != 0:
            raise AssertionError("play exited non-zero")
        recs = records.load_all_games(games_dir)
        replay_out = io.StringIO()
        with contextlib.redirect_stdout(replay_out):
            rc = cli.main(argv + ["replay", os.path.join(games_dir, f"{recs[0].id}.json"),
                                  "--no-wait"])
        if rc != 0:
            raise AssertionError("replay exited non-zero")
    finally:
        versus.play, records.replay_game = real_play, real_replay
    res, launches = taps["result"], taps["launches"]

    tally = {k: int(out.getvalue().split(f"{k}: ", 1)[1].split()[0])
             for k in ("Wins Player 1", "Wins Player 2", "Draws", "Number of Games")}
    if sum(tally[k] for k in ("Wins Player 1", "Wins Player 2", "Draws")) != games \
            or tally["Number of Games"] != games:
        raise AssertionError(f"the tally {tally} does not sum to {games}")
    if f"saved {games} game records to {games_dir}" not in out.getvalue() or len(recs) != games:
        raise AssertionError(f"{len(recs)} records written, not {games}")
    winners = [r.winner for r in recs]
    if (winners.count("mcts"), winners.count("random"), winners.count("none")) != (
            tally["Wins Player 1"], tally["Wins Player 2"], tally["Draws"]):
        raise AssertionError(f"the records' winners disagree with the tally {tally}")
    if any(len(r.turns) != res.rounds for r in recs) or res.mcts_searches != res.rounds:
        raise AssertionError(f"{res.rounds} rounds, {res.mcts_searches} searches, turns "
                             f"{sorted({len(r.turns) for r in recs})}")
    text = replay_out.getvalue()
    n_turns = len(recs[0].turns)
    if not text.startswith(f"Game ID: {recs[0].id}\n") or text.count(
            "State after action has been played:") != n_turns:
        raise AssertionError("the replay did not re-apply every recorded turn:\n" + text)
    if not bool(bg.validate_state(taps["final"]).all()):
        raise AssertionError("the replay's last board fails validate_state")
    _check_launches(dev, "mcts_arena", launches, _match_launches(res, iterations))
    say("mcts", f"tally {tally['Wins Player 1']}/{tally['Wins Player 2']}/{tally['Draws']} "
        f"(mcts/random/draws) of {games}, {len(recs)} records whose winners agree; replay of "
        f"{recs[0].id} re-applied {n_turns} turns, last board valid")
    moves = res.rounds
    say("mcts", f"on {card}: {moves} moves in {wall:.2f}s: {wall / moves:.3f} s a move, "
        f"{res.mcts_searches * iterations / wall:.2f} search iterations/s "
        f"({games * res.mcts_searches * iterations / wall:.0f} game-iterations/s); "
        f"launches gather={launches['gather_rows']} scatter={launches['scatter_rows']}"
        + (" (equal what the searches predict)" if dev.type == "cuda" else "")
        + (f"; peak device memory {peak / 2 ** 30:.3f} GiB" if peak is not None else ""))
    return launches


def _check_kernels_at(dev, shapes, seed, phase) -> dict:
    """Each kernel against its plain version, bit for bit, at every store
    shape ``(B, N, L)`` of ``shapes`` (a path's launches), with false mask
    rows and out-of-range idx; returns the largest |err| by kernel."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err = {"gather_rows": 0.0, "scatter_rows": 0.0}
    stores = sorted({k[1:] for k in shapes}, reverse=True)
    for b, n, length in stores:
        _row_check(dev, gen, b, n, length, b >= 3, max_err)
    if shapes:
        say(phase, "gather and scatter equal their plain versions bit for bit at [B, N, L] = "
            + ", ".join(f"[{b}, {n}, {length}]" for b, n, length in stores)
            + " (false mask rows where B >= 3)")
    return max_err


def _batches(counter) -> str:
    return ", ".join(f"{b} x{c}" for b, c in sorted(counter.items(), reverse=True))


def _check_ttt_trajectory(traj, games) -> dict:
    """A tic-tac-toe self-play record from empty boards: every game ended
    (a winner, or a full board); each game's fragments are its moves, one
    a round from round 0, at its own index (one more piece on the board
    each); the winner is the player of the game's last move; every
    fragment's outcome is the winner from its player's side.  Returns the
    tally."""
    import numpy as np

    valid = traj.valid.cpu().numpy()
    player = traj.player.cpu().numpy()
    winner = traj.winner.cpu().numpy()
    outcome = traj.outcome.cpu().numpy()
    empty = traj.obs[..., 1].sum((-1, -2)).cpu().numpy()
    n = valid.sum(0)
    if winner.shape != (games,):
        raise AssertionError(f"winner shape {winner.shape}")
    for g in range(games):
        k = int(n[g])
        if not valid[:k, g].all() or valid[k:, g].any():
            raise AssertionError(f"game {g}: fragments not one a round from round 0")
        if not np.array_equal(empty[:k, g], 9 - np.arange(k)):
            raise AssertionError(f"game {g}: a fragment off its game or its round")
        if (winner[g] == 0 and k != 9) or (winner[g] != 0 and player[k - 1, g] != winner[g]):
            raise AssertionError(f"game {g}: winner {winner[g]} after {k} moves, last "
                                 f"mover {player[k - 1, g]}")
        if not np.array_equal(outcome[:k, g], winner[g] * player[:k, g]):
            raise AssertionError(f"game {g}: outcomes are not the winner from each side")
    tally = {w: int((winner == w).sum()) for w in (-1, 1, 0)}
    if sum(tally.values()) != games:
        raise AssertionError(f"tally {tally}")
    return tally


def phase_compaction(dev, cfg, games, iterations, seed, card):
    """Tic-tac-toe self-play with live-game compaction (and without, for
    the wall time), then the CLI's ``play -1 mcts -2 random
    --compact-arena -o``; returns the kernels' launches by path and their
    launch shapes."""
    import io

    import torch

    from die_e_tpu_torch.arena import records, versus
    from die_e_tpu_torch.cli import main as cli
    from die_e_tpu_torch.envs import tictactoe as ttt
    from die_e_tpu_torch.envs.base import batch_size
    from die_e_tpu_torch.nets.resnet import make_net
    from die_e_tpu_torch.ops import rows as R
    from die_e_tpu_torch.train import self_play as sp
    from die_e_tpu_torch.train.learner import net_eval_fn

    m = cfg.mcts
    net = make_net(ttt.SPEC, seed, dev)
    sp_min, arena_min = _min_batches(games)
    say("compaction", f"tic-tac-toe self-play, {games} games, {iterations} simulations, "
        f"net {ttt.SPEC.n_filters}x{ttt.SPEC.n_res_blocks}, A = {ttt.NUM_ACTIONS}, round "
        f"limit 9 (every game ends), min_batch {sp_min}; with compaction, then without")
    launches, shapes, walls = {}, {}, {}
    for compact in (True, False):
        key = "compaction_self_play" if compact else "self_play_uncompacted"
        seen = collections.Counter()
        real = sp.alpha_search

        def search(env, eval_fn, states, *a, **kw):
            seen[batch_size(states)] += 1
            return real(env, eval_fn, states, *a, **kw)

        sp.alpha_search = search
        try:
            _sync(dev)
            R.reset_launches()
            t0 = time.perf_counter()
            traj = sp.self_play(
                ttt.ENV, net_eval_fn(net), torch.Generator(device=dev).manual_seed(seed),
                batch_size=games, iterations=iterations, c=m.c,
                dirichlet_alpha=m.dirichlet_alpha, dirichlet_epsilon=m.dirichlet_epsilon,
                temperature=cfg.alphazero.temperature, round_limit=9, negamax=m.negamax,
                device=dev, compact=compact, min_batch=sp_min)
            _sync(dev)
            walls[key] = time.perf_counter() - t0
        finally:
            sp.alpha_search = real
        launches[key], shapes[key] = dict(R.launches), collections.Counter(R.launch_shapes)
        tally = _check_ttt_trajectory(traj, games)
        rounds = traj.obs.shape[0]
        _check_launches(dev, key, launches[key], _puct_launches(traj.levels, rounds, iterations))
        if compact and len(seen) < 2:
            raise AssertionError(f"compaction never fired: batches {dict(seen)}")
        say("compaction", f"{'with' if compact else 'without'} compaction on {card}: "
            f"{rounds} rounds in {walls[key]:.2f}s, batches {_batches(seen)} "
            f"({traj.row_rounds} game rows searched), {int(traj.valid.sum())} fragments, "
            f"tally {tally[-1]}/{tally[1]}/{tally[0]} (x/o/draws); every game ended, "
            "its fragments and winner on its own game id; launches " + ", ".join(
                f"{k}={v}" for k, v in launches[key].items())
            + (" (equal what the searches predict)" if dev.type == "cuda" else ""))

    run_dir = os.path.join(ROOT, "build", f"compaction-{os.getpid()}-{int(time.time())}")
    games_dir = os.path.join(run_dir, "games")
    os.makedirs(run_dir)
    cuts = dict(iterations=iterations, arena_round_limit=9, simulate_round_limit=9)
    cfg_path = _config_copy(os.path.join(run_dir, "ttt.toml"), cuts)
    say("compaction", f"the CLI's play -1 mcts -2 random --compact-arena, tic-tac-toe, "
        f"{games} games, {iterations} UCB1 iterations a move, 9-step playouts, min_batch "
        f"{arena_min}; in {run_dir}")
    taps, seen = {}, collections.Counter()
    real_play, real_actions = versus.play, versus._round_actions

    def play(*a, **kw):
        R.reset_launches()
        taps["result"] = real_play(*a, min_batch=arena_min, **kw)
        _sync(dev)
        taps["launches"] = dict(R.launches)
        taps["shapes"] = collections.Counter(R.launch_shapes)
        return taps["result"]

    def round_actions(env, p1, p2, states, *a, **kw):
        seen[batch_size(states)] += 1
        return real_actions(env, p1, p2, states, *a, **kw)

    out = io.StringIO()
    argv = ["--device", dev.type, "--seed", str(seed), "-g", "tictactoe", "-c", cfg_path,
            "--compact-arena", "play", "-1", "mcts", "-2", "random", "--num-games", str(games),
            "-o", games_dir]
    versus.play, versus._round_actions = play, round_actions
    try:
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        versus.play, versus._round_actions = real_play, real_actions
    if rc != 0:
        raise AssertionError("play exited non-zero")
    res = taps["result"]
    launches["compaction_arena"], shapes["compaction_arena"] = taps["launches"], taps["shapes"]
    if res.wins_p1 + res.wins_p2 + res.draws != games or len(seen) < 2:
        raise AssertionError(f"tally {res.wins_p1}/{res.wins_p2}/{res.draws}, batches {seen}")
    recs = records.load_all_games(games_dir)
    kinds = {-1: "mcts", 1: "random", 0: "none"}
    for rec in recs:  # each game replays on the cpu to its recorded winner
        st = ttt.TttState(board=torch.tensor([rec.initial_state["board"]], dtype=torch.int32),
                          player=torch.tensor([rec.initial_state["player"]], dtype=torch.int32))
        for turn in rec.turns:
            st = ttt.step(st, torch.tensor([turn.action]))
        if not bool(ttt.done(st)[0]) or kinds[int(ttt.winner(st)[0])] != rec.winner:
            raise AssertionError(f"record {rec.id} replays to another result")
    if len(recs) != games or [r.winner for r in recs].count("mcts") != res.wins_p1:
        raise AssertionError(f"{len(recs)} records, tally {res.wins_p1}")
    _check_launches(dev, "compaction_arena", launches["compaction_arena"],
                    _match_launches(res, iterations))
    say("compaction", f"on {card}: {res.rounds} rounds in {wall:.2f}s, batches "
        f"{_batches(seen)}, tally {res.wins_p1}/{res.wins_p2}/{res.draws} (mcts/random/draws) "
        f"of {games}; all {games} records replay to their winners; launches " + ", ".join(
            f"{k}={v}" for k, v in launches["compaction_arena"].items())
        + (" (equal what the searches predict)" if dev.type == "cuda" else ""))
    shutil.rmtree(games_dir)
    return launches, shapes


def _min_batches(games):
    """(self-play, arena) min_batch: the JAX package's defaults, 128 and 64,
    at full width; a CPU rehearsal's few games scale them down so that
    compaction still fires."""
    return min(128, max(2, games // 8)), min(64, max(2, games // 16))


def _dp_step_check(dev, spec, rank, init, seed) -> str:
    """One train step on a 2-process group (each process on its half of a
    batch of 64, weight-0 rows in the second half) against one process on
    the whole batch, TF32 off: loss, gradients, BatchNorm running
    statistics, Adam's moments and the parameters after the step."""
    import torch.distributed as dist

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.parallel.multihost import all_reduce_, batch_slice, initialize_multihost
    from die_e_tpu_torch.train.learner import create_train_state, set_process_group, train_step

    cluster = initialize_multihost(init, 2, rank, device=dev.type)
    try:
        obs = bg.observe(_random_states(bg, 64, 12, dev, seed))
        batch = [x.to(dev) for x in _step_batch(spec, obs, seed)]
        two = set_process_group(create_train_state(spec, seed, device=dev), dist.group.WORLD)
        one = create_train_state(spec, seed, device=dev)
        _set_tf32(False)  # after resolve_device, which turns TF32 on
        p0 = {k: p.detach().cpu().clone() for k, p in one.net.named_parameters()}
        mine = batch_slice(64, rank, 2)
        _sync(dev)
        t0 = time.perf_counter()
        _, m2 = train_step(two, *(x[mine] for x in batch), batch[3].sum().clamp_min(1.0))
        _sync(dev)
        step_s = time.perf_counter() - t0
        loss2 = all_reduce_(m2["loss"].detach().clone(), dist.group.WORLD).item()
        _, m1 = train_step(one, *batch)
        errs = _step_errors(_step_outputs(two, loss2, p0),
                            _step_outputs(one, m1["loss"].item(), p0), p0,
                            one.opt.param_groups[0])
        cost = _all_reduce_cost(dev)
    finally:
        _set_tf32(dev.type == "cuda")
        cluster.close()
    # float32 with TF32 off on both sides: only the order of sums differs
    tol = {"loss": 1e-5, "grads": 1e-5, "running stats": 1e-5, "exp_avg": 1e-5,
           "exp_avg_sq": 2e-5, "adam update": 1e-6, "params": 1.0}
    return (f"2-process train step ({spec.n_filters}x{spec.n_res_blocks}, batch 64 as 2 x 32, "
            f"weight-0 rows in the second half, TF32 off, {cluster.backend}, first step "
            f"{step_s * 1e3:.1f} ms) against one process: "
            + _check_errors("2-process train step", errs, tol) + " " + STEP_ERRORS_DOC
            + "; " + cost)


def _all_reduce_cost(dev) -> str:
    """The time of the data-parallel step's collectives at full width,
    over the default group: one all-reduce of the 256x19 net's gradients a
    step, and two of one BatchNorm's sums for each of its BatchNorms a step
    (forward: 2 x 256 + 1 float64; backward: 2 x 256 float32; timed as
    513 float64)."""
    import torch
    import torch.distributed as dist

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.nets.resnet import BatchNorm, PolicyValueNet
    from die_e_tpu_torch.parallel.multihost import all_reduce_

    with torch.device("meta"):
        net = PolicyValueNet(bg.SPEC)
    n_grad = sum(p.numel() for p in net.parameters())
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())

    def timed(t, reps):
        all_reduce_(t, dist.group.WORLD)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            all_reduce_(t, dist.group.WORLD)
        _sync(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    grad_ms = timed(torch.zeros(n_grad, device=dev), 3)
    bn_ms = timed(torch.zeros(2 * bg.SPEC.n_filters + 1, dtype=torch.float64, device=dev), 30)
    return (f"{dist.get_backend()} all-reduce on {dev.type} at full width: the gradients "
            f"({n_grad:,} f32, {n_grad * 4 / 1e6:.1f} MB) {grad_ms:.2f} ms, a BatchNorm's sums "
            f"({2 * bg.SPEC.n_filters + 1} f64) {bn_ms:.3f} ms, x {2 * n_bn} a step "
            f"({n_bn} BatchNorms x 2) = {2 * n_bn * bn_ms:.1f} ms")


def rank_worker(args) -> int:
    """One process of the 2-process learn phase: the 2-process train step
    check, then the CLI's ``learn`` as process ``args.rank_worker`` of 2,
    with the learn phase's taps; writes ``rank{i}.json`` into the run
    directory."""
    import torch

    from die_e_tpu_torch.cli import main as cli
    from die_e_tpu_torch.core.device import resolve_device
    from die_e_tpu_torch.envs import backgammon as bg

    rank, run_dir = args.rank_worker, args.run_dir
    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = resolve_device(args.device)
    spec = _spec(args)
    report = {"train_step": _dp_step_check(
        dev, dataclasses.replace(bg.SPEC, n_filters=32, n_res_blocks=2), rank,
        f"file://{run_dir}/rendezvous-step", args.seed)}
    from die_e_tpu_torch.core.config import load_config

    iterations = args.iterations or load_config(CONFIG).mcts.iterations
    with contextlib.ExitStack() as stack:
        stack.enter_context(_game_at(spec))
        taps = stack.enter_context(_Taps(dev, iterations))
        os.chdir(run_dir)
        rc = cli.main(["--device", args.device, "--seed", str(args.seed), "-g", "backgammon",
                       "-c", "learn2.toml", "--metrics-jsonl", "metrics.jsonl",
                       "--coordinator", f"file://{run_dir}/rendezvous-learn",
                       "--num-processes", "2", "--process-id", str(rank), "learn"])
    report.update(rc=rc, seconds=taps.seconds, steps=taps.steps, launches=taps.launches,
                  shapes={k: [[*s, c] for s, c in v.items()] for k, v in taps.shapes.items()})
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return rc


def phase_learn_2proc(dev, spec, games, iterations, seed, learn_dir, argv):
    """The port's CLI ``learn`` as 2 processes on this one device (gloo),
    from the learn phase's ``best``; returns the kernels' launches by path
    and their launch shapes."""
    import json as json_

    import numpy as np

    run_dir = os.path.join(ROOT, "build", f"learn2-{os.getpid()}-{int(time.time())}")
    mdir = os.path.join(run_dir, "models", "backgammon")
    os.makedirs(mdir)
    shutil.copytree(os.path.join(learn_dir, "models", "backgammon", "best"),
                    os.path.join(mdir, "best"))
    cuts = dict(LEARN2_CUTS, num_self_play_batches=games, iterations=iterations)
    _config_copy(os.path.join(run_dir, "learn2.toml"), cuts)
    say("learn2", f"the CLI's learn as 2 processes (gloo, one device), configs/bg_full.toml "
        f"at B={games} ({games // 2} a process) iterations={iterations} net="
        f"{spec.n_filters}x{spec.n_res_blocks}, cut to "
        + ", ".join(f"{k}={v}" for k, v in LEARN2_CUTS.items())
        + f", from the learn phase's best; in {run_dir}")
    # one thread a process: gloo's small all-reduces wait less for the host
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(run_dir, f"rank{r}.log"), "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker",
                               str(r), "--run-dir", run_dir, *argv],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(60.0, BUDGET_S - elapsed()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = open(os.path.join(run_dir, f"rank{r}.log")).read()[-4000:]
            raise AssertionError(f"process {r} exited {p.returncode}:\n{tail}")
    reports = [json_.load(open(os.path.join(run_dir, f"rank{r}.json"))) for r in range(2)]
    events = [[json_.loads(line) for line in open(os.path.join(run_dir, name))]
              for name in ("metrics.jsonl", "metrics.jsonl.p1")]

    def series(evs, event, key):
        return [e[key] for e in evs if e["event"] == event]

    frags, losses = ([series(ev, e, k) for ev in events]
                     for e, k in (("self_play", "fragments"), ("train_epoch", "loss")))
    if frags[0] != frags[1] or losses[0] != losses[1] or not losses[0] or not all(
            np.isfinite(losses[0])):
        raise AssertionError(f"fragments {frags}, losses {losses}")
    if series(events[0], "dist", "backend") != ["gloo"] * 1 or series(
            events[1], "dist", "rank") != [1]:
        raise AssertionError(f"dist events {[series(ev, 'dist', 'backend') for ev in events]}")
    gates = [e for e in events[0] if e["event"] == "gate"]
    if len(gates) != 1 or (gates[0]["result"], gates[0]["games"]) != ("best_kept", 100):
        raise AssertionError(f"gates {gates}")
    if any(e["event"] in ("gate", "model_saved") for e in events[1]) or any(
            k in reports[1]["seconds"] for k in ("gate", "checkpoint writes")):
        raise AssertionError("process 1 gated or wrote a checkpoint")
    run_id = series(events[0], "run_start", "run_id")[0]
    for rel in ("models/backgammon/model_0", "models/backgammon/latest_state",
                f"data/backgammon/run-{run_id}/lrn-0/sp-0/memory.npz"):
        if not os.path.exists(os.path.join(run_dir, rel)):
            raise AssertionError(f"missing {rel}")
    meta = json_.load(open(os.path.join(mdir, "latest_meta.json")))
    if meta != {"run_id": run_id, "next_learn_iter": 1}:
        raise AssertionError(f"resume cursor {meta}")
    launches, shapes = {}, {}
    for r, rep in enumerate(reports):
        for path, counts in rep["launches"].items():
            if counts:
                launches[f"learn2_{path[len('learn_'):]}_p{r}"] = counts
                shapes[f"learn2_{path[len('learn_'):]}_p{r}"] = collections.Counter(
                    {tuple(x[:4]): x[4] for x in rep["shapes"][path]})
        at_half = shapes[f"learn2_self_play_p{r}"]
        if dev.type == "cuda" and not all(at_half[(k, games // 2, iterations + 1, 2048)] > 0
                                          for k in ("gather_rows", "scatter_rows")):
            raise AssertionError(f"process {r} did not launch both kernels at B = {games // 2}")
    say("learn2", reports[0]["train_step"])
    say("learn2", f"2 processes in {wall:.2f}s (process start included); fragments {frags[0]} "
        f"and losses {', '.join(f'{x:.4f}' for x in losses[0])} identical on both; only process "
        "0 gated (best_kept, 100 draws) and wrote checkpoints, data and the cursor")
    for r, rep in enumerate(reports):
        secs = rep["seconds"]
        say("learn2", f"process {r} wall time by stage: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in secs.items())
            + f"; {rep['steps']} train steps, {rep['steps'] / secs['train']:.2f} steps/s "
            f"({1e3 * secs['train'] / rep['steps']:.1f} ms a step, data-parallel over gloo)")
    for path, counts in launches.items():
        say("learn2", f"{path}: launches " + ", ".join(f"{k}={v}" for k, v in counts.items())
            + (" at B = " + ", ".join(str(b) for b in sorted({k[1] for k in shapes[path]}))
               + " (each call's counts equal what its search levels predict)"
               if dev.type == "cuda" else ""))
    return launches, shapes


# ---------------------------------------------------------------------------
# the strength and learning checks (die_e_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

LADDER_RUNGS = "random,mcts16"  # the model-vs-mcts rung: 16 iterations a move, trees [B, 17, L]
LADDER_GAMES, ELO_GAMES = 32, 16
SCRIPT_ROUNDS = 2  # the ladder's and tournament's round limit (of 300); the bg demo's (of 160/200)
PARITY_GAMES, PARITY_STEPS = 2048, 1500


def _run_dir(name) -> str:
    path = os.path.join(ROOT, "build", f"{name}-{os.getpid()}-{int(time.time())}")
    os.makedirs(path)
    return path


def _run_main(main_fn, argv, **kw):
    """(exit code, stdout, stderr) of a script's ``main`` run in-process."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def _json_rows(text, metric) -> list:
    return [r for r in (json.loads(line) for line in text.splitlines() if line.startswith("{"))
            if r.get("metric") == metric]


def _match_launches(res, iterations, mcts_iterations=None) -> dict:
    """What one match's searches launch: the model's PUCT searches, one a
    round whenever a model plays (:func:`_puct_launches`), plus the
    pure-rollout searches (``mcts_iterations`` a move, by default
    ``iterations``), one gather per iteration and one scatter per
    iteration and per search."""
    from die_e_tpu_torch.arena.versus import Agent

    puct = res.rounds if Agent.MODEL in (res.player1, res.player2) else 0
    n = iterations if mcts_iterations is None else mcts_iterations
    want = _puct_launches(res.levels, puct, iterations)
    return {"gather_rows": want["gather_rows"] + res.mcts_searches * n,
            "scatter_rows": want["scatter_rows"] + res.mcts_searches * (n + 1)}


class _MatchTaps:
    """Wrap ``play`` as ``modules`` name it: each match's kernel launches
    are set to 0 just before it and read just after, checked against
    :func:`_match_launches`, and summed by path (``path(p1, p2, kw)``
    names it); each match's path, result and wall time are kept.  Restores
    the modules on exit."""

    def __init__(self, dev, path, *modules):
        self.dev, self.path, self.modules = dev, path, modules
        self.launches, self.shapes, self.matches = {}, {}, []
        self._real = []

    def __enter__(self):
        for mod in self.modules:
            self._real.append((mod, mod.play))
            mod.play = lambda *a, _real=mod.play, **kw: self._play(_real, *a, **kw)
        return self

    def __exit__(self, *exc):
        for mod, real in self._real:
            mod.play = real

    def _play(self, real, env, p1, p2, gen, cfg, **kw):
        from die_e_tpu_torch.ops import rows as R

        path = self.path(p1, p2, kw)
        _sync(self.dev)
        R.reset_launches()
        t0 = time.perf_counter()
        res = real(env, p1, p2, gen, cfg, **kw)
        _sync(self.dev)
        wall = time.perf_counter() - t0
        got = dict(R.launches)
        _check_launches(self.dev, path, got,
                        _match_launches(res, cfg.iterations, kw.get("mcts_iterations")))
        total = self.launches.setdefault(path, {k: 0 for k in got})
        for k, v in got.items():
            total[k] += v
        self.shapes.setdefault(path, collections.Counter()).update(R.launch_shapes)
        self.matches.append((path, res, wall))
        return res


def _launch_line(launches, dev) -> str:
    return ", ".join(f"{k}={v}" for k, v in launches.items()) + (
        " (equal what the searches predict)" if dev.type == "cuda" else "")


def phase_ladder(dev, spec, learn_dir, iterations, games, seed, card):
    """The port's strength ladder on the learn phase's ``best``: rungs
    random and mcts16 in one block each, then the same command again with
    its resume state; returns the kernels' launches by path and their
    launch shapes."""
    from die_e_tpu_torch.scripts import strength_ladder

    run_dir = _run_dir("ladder")
    out, state = os.path.join(run_dir, "ladder.jsonl"), os.path.join(run_dir, "state.json")
    argv = ["--model-path", os.path.join(learn_dir, "models", "backgammon", "best"),
            "--name", "best", "--rungs", LADDER_RUNGS, "--games", str(games),
            "--block", str(games), "--sims", str(iterations), "--rollout-limit", "4",
            "--round-limit", str(SCRIPT_ROUNDS), "--seed", str(seed), "--out", out,
            "--resume-state", state, "--device", dev.type]
    say("ladder", f"strength_ladder on the learn phase's best (net {spec.n_filters}x"
        f"{spec.n_res_blocks}, {iterations} simulations a move), rungs {LADDER_RUNGS}, "
        f"{games} games in one block, 4-step playouts, cut to {SCRIPT_ROUNDS} rounds (of 300); "
        f"then again with its --resume-state; in {run_dir}")

    def path(p1, p2, kw):
        return f"ladder_model_vs_{p2.kind.value}{kw.get('mcts_iterations') or ''}"

    with _game_at(spec), _MatchTaps(dev, path, strength_ladder) as taps:
        rc, text, _ = _run_main(strength_ladder.main, argv)
        played = list(taps.matches)
        saved = open(state).read(), open(out).read()
        rc2, text2, err2 = _run_main(strength_ladder.main, argv)
    rows = _json_rows(text, "strength_ladder")
    if rc != 0 or [(r["rung"], r["games"], r["wins"] + r["losses"] + r["draws"]) for r in rows] \
            != [(rung, games, games) for rung in LADDER_RUNGS.split(",")]:
        raise AssertionError(f"ladder rc {rc}, rows {rows}")
    if rows[1]["rollout_limit"] != 4 or any(
            (r["model_sims"], r["round_limit"]) != (iterations, SCRIPT_ROUNDS) for r in rows):
        raise AssertionError(f"ladder rows {rows}")
    mcts = [res for p, res, _ in played if "mcts" in p]
    if len(played) != 2 or len(mcts) != 1 or mcts[0].mcts_searches != mcts[0].rounds:
        raise AssertionError(f"ladder matches {played}")
    # the resumed run plays nothing, skips both rungs and changes no file
    skips = _json_rows(err2, "ladder_skip")
    if rc2 != 0 or len(taps.matches) != 2 or _json_rows(text2, "strength_ladder") or [
            r["rung"] for r in skips] != LADDER_RUNGS.split(",") or saved != (
            open(state).read(), open(out).read()):
        raise AssertionError(f"the resumed ladder played or wrote: rc {rc2}, {text2}, {err2}")
    for (p, res, wall), row in zip(played, rows):
        say("ladder", f"rung {row['rung']}: {row['wins']}/{row['losses']}/{row['draws']} "
            f"(wins/losses/draws) of {row['games']}, verdict {row['verdict']}; on {card}: "
            f"{res.rounds} moves in {wall:.2f}s, {wall / max(res.rounds, 1):.3f} s a move; "
            f"launches {_launch_line(taps.launches[p], dev)}")
    say("ladder", "the relaunch with --resume-state played nothing: a ladder_skip line for "
        f"{', '.join(r['rung'] for r in skips)}, state and rows unchanged: "
        + json.dumps([{k: r[k] for k in ("rung", "games", "wins", "losses", "draws")}
                      for r in _json_rows(open(out).read(), "strength_ladder")]))
    return taps.launches, taps.shapes


def phase_elo(dev, spec, learn_dir, iterations, games, seed, card):
    """The port's Elo tournament between the learn phase's ``best`` and
    ``model_1`` and the random anchor, then again on the cached matches;
    returns the kernels' launches by path and their launch shapes."""
    from die_e_tpu_torch.arena.versus import Agent
    from die_e_tpu_torch.scripts import elo_tournament
    from die_e_tpu_torch.train import checkpoint as ckpt

    run_dir = _run_dir("elo")
    out = os.path.join(run_dir, "elo.jsonl")
    mdir = os.path.join(learn_dir, "models", "backgammon")
    argv = ["--models", f"best={mdir}/best,model_1={mdir}/model_1", "--anchors", "random",
            "--games", str(games), "--sims", str(iterations),
            "--round-limit", str(SCRIPT_ROUNDS), "--seed", str(seed), "--out", out,
            "--device", dev.type]
    say("elo", f"elo_tournament: the learn phase's best and model_1 (net {spec.n_filters}x"
        f"{spec.n_res_blocks}, {iterations} simulations a move) and the random anchor, "
        f"{games} games a pair, cut to {SCRIPT_ROUNDS} rounds (of 300); then again on its "
        f"cached matches; in {run_dir}")
    loads, real_load = [], ckpt.load_net

    def load_net(path, *a, **kw):
        loads.append(path)
        return real_load(path, *a, **kw)

    def path(p1, p2, kw):
        return "elo_model_vs_" + ("model" if p2.kind == Agent.MODEL else p2.kind.value)

    ckpt.load_net = load_net
    try:
        with _game_at(spec), _MatchTaps(dev, path, elo_tournament) as taps:
            rc, text, _ = _run_main(elo_tournament.main, argv)
            ratings = open(os.path.splitext(out)[0] + ".ratings.json").read()
            n_loads = len(loads)
            rc2, text2, _ = _run_main(elo_tournament.main, argv)
    finally:
        ckpt.load_net = real_load
    matches = _json_rows(text, "elo_match")
    (summary,) = _json_rows(text, "elo_ratings")
    pairs = [(m["player_a"], m["player_b"]) for m in matches]
    if rc != 0 or pairs != [("best", "model_1"), ("best", "random"), ("model_1", "random")] or any(
            m["wins_a"] + m["wins_b"] + m["draws"] != games for m in matches) or n_loads != 2:
        raise AssertionError(f"tournament rc {rc}, matches {matches}, {n_loads} models loaded")
    if summary["anchor"] != "random" or set(summary["ratings"]) != {"best", "model_1", "random"}:
        raise AssertionError(f"ratings {summary}")
    if rc2 != 0 or len(taps.matches) != 3 or _json_rows(text2, "elo_match") or len(loads) != 2 \
            or _json_rows(text2, "elo_ratings") != [summary] or open(
            os.path.splitext(out)[0] + ".ratings.json").read() != ratings:
        raise AssertionError(f"the cached tournament played, loaded or rated anew: {text2}")
    for (p, res, wall), m in zip(taps.matches, matches):
        say("elo", f"{m['player_a']} against {m['player_b']}: {m['wins_a']}/{m['wins_b']}/"
            f"{m['draws']} of {games}; on {card}: {res.rounds} moves in {wall:.2f}s, "
            f"{wall / max(res.rounds, 1):.3f} s a move")
    for p, launches in taps.launches.items():
        say("elo", f"{p}: launches {_launch_line(launches, dev)}")
    say("elo", f"ratings {json.dumps(summary['ratings'])}, ci95 {json.dumps(summary['ci95'])}; "
        "the cached re-run played nothing, loaded no model, and gave identical ratings")
    return taps.launches, taps.shapes


def _learn_check_taps(taps, final, prefix):
    """The learn loop's and the final match's launches and shapes under
    ``prefix`` names."""
    launches, shapes = {}, {}
    for key, name in (("learn_self_play", "self_play"), ("learn_arena", "gate")):
        if taps.launches[key]:
            launches[f"{prefix}_{name}"] = taps.launches[key]
            shapes[f"{prefix}_{name}"] = taps.shapes[key]
    for p in final.launches:
        launches[p], shapes[p] = final.launches[p], final.shapes[p]
    return launches, shapes


def _stage_line(taps, final) -> str:
    (_, res, wall), = final.matches
    return ", ".join(f"{k} {v:.3f}s" for k, v in taps.seconds.items()) + (
        f"; final arena {res.rounds} moves in {wall:.2f}s, {wall / max(res.rounds, 1):.3f} s a "
        f"move; {taps.steps} train steps")


def _tally(text) -> dict:
    return {k: int(text.split(f"{k}: ", 1)[1].split()[0])
            for k in ("Wins Player 1", "Wins Player 2", "Draws", "Number of Games")}


def phase_ttt_learn(dev, args, card):
    """The port's tic-tac-toe exit check cut to 2 learn iterations of 1
    self-play run (a CPU rehearsal also cuts its games, simulations and
    net);
    prints the non-loss rate without gating on it.  Returns the kernels'
    launches by path and their launch shapes."""
    from die_e_tpu_torch.envs import tictactoe as ttt
    from die_e_tpu_torch.scripts import ttt_learning_check as check

    spec = _spec(args, ttt)
    run_dir = _run_dir("ttt-learn")
    iterations = args.iterations or check.main.__kwdefaults__["iterations"]
    games = args.games or check.main.__kwdefaults__["games"]
    cuts = dict(learn_iterations=2, self_play_iterations=1)
    say("ttt-learn", f"ttt_learning_check ({games} games a self-play run, {iterations} "
        f"simulations a move, net {spec.n_filters}x{spec.n_res_blocks}, 128-game gates, then 400 "
        "games against random) cut to "
        + ", ".join(f"{k}={v}" for k, v in cuts.items()) + f" (of 24 and 2); in {run_dir}")
    t0 = time.perf_counter()
    with _game_at(spec, ttt), _Taps(dev, iterations) as taps, _MatchTaps(
            dev, lambda *a: "ttt_final_arena", check) as final:
        rc, text, _ = _run_main(check.main, [run_dir, "--device", dev.type],
                                iterations=iterations, games=games, **cuts)
    wall = time.perf_counter() - t0
    tally = _tally(text)
    rate = float(text.split("NON-LOSS RATE vs random: ", 1)[1].split()[0])
    if rc not in (0, 1) or tally["Number of Games"] != 400 or rc != (0 if rate > 0.95 else 1) \
            or abs(rate - (tally["Wins Player 1"] + tally["Draws"]) / 400) > 5e-4:
        raise AssertionError(f"ttt_learning_check rc {rc}:\n{text}")
    mdir = os.path.join(run_dir, "models", "tictactoe")
    if not all(os.path.isdir(os.path.join(mdir, m)) for m in ("model_0", "model_1", "best")):
        raise AssertionError(f"missing checkpoints in {mdir}")
    launches, shapes = _learn_check_taps(taps, final, "ttt")
    say("ttt-learn", f"on {card}: {wall:.2f}s; non-loss rate against random {rate:.3f} "
        f"({tally['Wins Player 1']}/{tally['Wins Player 2']}/{tally['Draws']} of 400; the cut "
        "run is not the exit check, which wants > 0.95 after 24 iterations); "
        + _stage_line(taps, final))
    for p, counts in launches.items():
        say("ttt-learn", f"{p}: launches {_launch_line(counts, dev)}")
    return launches, shapes


def phase_bg_demo(dev, spec, args, card):
    """The port's backgammon learning demo cut to 2 learn iterations of 2
    self-play rounds, a 2-round gate and a 2-round final arena, at full width (a CPU
    rehearsal also cuts its games, simulations and net); returns the
    kernels' launches by path and their launch shapes."""
    from die_e_tpu_torch.scripts import bg_learning_demo as demo

    run_dir = _run_dir("bg-demo")
    iterations = args.iterations or demo.main.__kwdefaults__["iterations"]
    games = args.games or demo.main.__kwdefaults__["games"]
    cuts = dict(learn_iterations=2, round_limit=SCRIPT_ROUNDS)
    say("bg-demo", f"bg_learning_demo ({games} games a self-play run, {iterations} simulations "
        f"a move, net {spec.n_filters}x{spec.n_res_blocks}, 64-game gates, then 128 games "
        "against random) cut to " + ", ".join(f"{k}={v}" for k, v in cuts.items())
        + f" (of 4, and 160/160/200 rounds); in {run_dir}")
    t0 = time.perf_counter()
    with _game_at(spec), _Taps(dev, iterations) as taps, _MatchTaps(
            dev, lambda *a: "bg_final_arena", demo) as final:
        rc, text, _ = _run_main(demo.main, [run_dir, "--device", dev.type],
                                iterations=iterations, games=games, **cuts)
    wall = time.perf_counter() - t0
    tally = _tally(text)
    if rc != 0 or "--- model vs random ---" not in text or tally["Number of Games"] != 128 or sum(
            tally[k] for k in ("Wins Player 1", "Wins Player 2", "Draws")) != 128:
        raise AssertionError(f"bg_learning_demo rc {rc}:\n{text}")
    mdir = os.path.join(run_dir, "models", "backgammon")
    if not all(os.path.isdir(os.path.join(mdir, m)) for m in ("model_0", "model_1", "best")):
        raise AssertionError(f"missing checkpoints in {mdir}")
    launches, shapes = _learn_check_taps(taps, final, "bg")
    if "bg_gate" not in launches:
        raise AssertionError("the second learn iteration played no gate match")
    say("bg-demo", f"on {card}: {wall:.2f}s; model against random {tally['Wins Player 1']}/"
        f"{tally['Wins Player 2']}/{tally['Draws']} of 128; " + _stage_line(taps, final))
    for p, counts in launches.items():
        say("bg-demo", f"{p}: launches {_launch_line(counts, dev)}")
    return launches, shapes


def phase_parity(dev, games, card) -> None:
    """The port's parity sweep: ``games`` seeded backgammon games on the
    device, played to their end or ``PARITY_STEPS``, against the C++
    oracle; no mismatch allowed."""
    from die_e_tpu_torch.scripts import parity_sweep

    say("parity", f"parity_sweep: {games} seeded games, max_steps {PARITY_STEPS}, the k-th "
        "legal action from the salted stream, against parity/oracle.py (built by g++ at first "
        "use)")
    t0 = time.perf_counter()
    rc, text, _ = _run_main(parity_sweep.main, [str(games), str(PARITY_STEPS),
                                                "--device", dev.type])
    wall = time.perf_counter() - t0
    line = text.strip().splitlines()[-1]
    if rc != 0 or f"games={games} " not in line or " mismatches=0 " not in line:
        raise AssertionError(f"parity sweep rc {rc}:\n{text}")
    say("parity", f"on {card}: {line}; {wall:.2f}s in all; zero mismatches in action hashes, "
        "winners and move counts")



def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()


def _add_path(paths, errs, dev, seed, phase, launches, shapes) -> None:
    """Add a phase's launches by path to ``paths``, and both kernels' errors
    at every shape it launched them on to ``errs``."""
    paths.update(launches)
    errs.append(_check_kernels_at(dev, sum(shapes.values(), collections.Counter()), seed, phase))


def phase_port_rest(dev, args, cfg, spec, games, iterations, learn_dir, card, errs):
    """Phases 7-9 (mcts, compaction, learn2); appends the kernels' errors at
    their launch shapes to ``errs`` and returns their launches by path."""
    mcts_launches = phase_mcts(dev, args.games or cfg.arena.num_games, iterations, args.seed,
                               card)
    check_budget("mcts")
    compaction, compaction_shapes = phase_compaction(dev, cfg, games, iterations, args.seed,
                                                     card)
    errs.append(_check_kernels_at(dev, sum(compaction_shapes.values(), collections.Counter()),
                                  args.seed, "compaction"))
    check_budget("compaction")
    rank_argv = ["--device", args.device, "--seed", str(args.seed)] + [
        f"--{k}={getattr(args, k)}" for k in ("games", "iterations", "filters", "blocks")
        if getattr(args, k) is not None]
    learn2, learn2_shapes = phase_learn_2proc(dev, spec, games, iterations, args.seed,
                                              learn_dir, rank_argv)
    errs.append(_check_kernels_at(dev, sum(learn2_shapes.values(), collections.Counter()),
                                  args.seed, "learn2"))
    check_budget("learn2")
    return {"mcts_arena": mcts_launches, **compaction, **learn2}


CHECKS = ("ladder", "elo", "ttt-learn", "bg-demo", "parity")


def phase_checks(dev, args, spec, iterations, learn_dir, card, errs, names):
    """Phases 10-14, the strength and learning checks (those in
    ``names``); appends the kernels' errors at their launch shapes to
    ``errs`` and returns their launches by path."""
    t_checks, checks = elapsed(), {}
    runs = {"ladder": lambda: phase_ladder(dev, spec, learn_dir, iterations,
                                           args.games or LADDER_GAMES, args.seed, card),
            "elo": lambda: phase_elo(dev, spec, learn_dir, iterations,
                                     args.games or ELO_GAMES, args.seed, card),
            "ttt-learn": lambda: phase_ttt_learn(dev, args, card),
            "bg-demo": lambda: phase_bg_demo(dev, spec, args, card)}
    for phase in names:
        if phase == "parity":
            phase_parity(dev, args.games or PARITY_GAMES, card)
        else:
            by_check, shapes = runs[phase]()
            checks.update(by_check)
            errs.append(_check_kernels_at(dev, sum(shapes.values(), collections.Counter()),
                                          args.seed, phase))
        check_budget(phase)
    say(names[-1], f"the {len(names)} phases of the strength and learning checks took "
        f"{elapsed() - t_checks:.1f}s")
    return checks


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device == "cuda" and args.phases != "all":
        print("chip_smoke: --phases splits a CPU rehearsal; the card runs every phase",
              file=sys.stderr, flush=True)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (use --device cpu to rehearse)",
              file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from die_e_tpu_torch.core.config import load_config
        from die_e_tpu_torch.core.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr, flush=True)
        return 2

    if args.rank_worker is not None:
        return rank_worker(args)
    os.environ.pop("DIE_E_BF16", None)  # f32 inference but in the bf16 phases, which set it
    dev = resolve_device("cuda:0" if args.device == "cuda" else "cpu")
    cfg = load_config(CONFIG)
    games = args.games or cfg.alphazero.num_self_play_batches
    iterations = args.iterations or cfg.mcts.iterations
    spec = _spec(args)
    from die_e_tpu_torch.ops.rows import pad_actions

    device = phase_device(dev)
    card = device.get("smi", "the cpu (rehearsal)")
    check_budget("device")
    phase_build(dev)
    check_budget("build")
    paths, errs, part = {}, [], PARTS[args.phases]
    if "port" in part:
        kernels = phase_kernels(dev, games, iterations + 1, pad_actions(spec.num_actions),
                                args.games or cfg.arena.num_games, args.seed)
        check_budget("kernels")
        phase_reference(dev, spec, games, iterations, args.seed)
        check_budget("reference")
        sp = phase_self_play(dev, cfg, spec, games, iterations, ROUNDS, args.seed)
        paths["self_play"] = sp["launches"]
        check_budget("self-play")
        _add_path(paths, errs, dev, args.seed, "bf16", *phase_bf16(
            dev, cfg, spec, games, iterations, ROUNDS, args.seed, sp, card))
        del sp
        check_budget("bf16")
    learn_dir = None
    if "learn" in part:
        by_path, _, learn_dir = phase_learn(dev, spec, games, iterations, args.seed)
        paths.update(by_path)
        check_budget("learn")
    if "port" in part:
        _add_path(paths, errs, dev, args.seed, "bf16", *phase_bf16_cli(
            dev, spec, learn_dir, args.games or LEARN_CUTS["arena_num_games"], iterations,
            args.seed, card))
        check_budget("bf16")
        phase_bn_probe(dev, spec, learn_dir, card)
        check_budget("bn-probe")
        paths.update(phase_port_rest(dev, args, cfg, spec, games, iterations, learn_dir, card,
                                     errs))
    names = tuple(n for n in CHECKS if n in part)
    if names:
        paths.update(phase_checks(dev, args, spec, iterations, learn_dir, card, errs, names))
    if dev.type != "cuda":
        say("done", "cpu rehearsal passed (no device numbers, no result line)")
        return 0
    for k in kernels:
        name = k["name"]
        k["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["max_abs_err"] = max([k["max_abs_err"]] + [e[name] for e in errs])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
