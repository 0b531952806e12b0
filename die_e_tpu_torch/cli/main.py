"""Command-line interface of the port: the port of ``die_e_tpu/cli/main.py``.

The same subcommands and flags: ``learn`` (``-m``, ``--resume``),
``train`` (``-m -o -r -l -s``), ``play`` (``-1``/``-2`` random, mcts or
model, ``--model1-path``, ``--model2-path``, ``-o`` for one JSON record
per game, ``--num-games``) and ``replay GAME_PATH [--no-wait]``, with the
global ``-c``/``--config``, ``-g``/``--game``, ``--seed``,
``--metrics-jsonl``, ``--mesh-data``/``--mesh-model`` and the cluster
flags ``--coordinator``/``--num-processes``/``--process-id``.
``--device cuda|cpu`` (default ``cuda``) takes the place of
``--platform``.  ``--compact-self-play`` and ``--compact-arena`` take the
place of the JAX package's ``DIE_E_SP_COMPACT=1`` and
``DIE_E_ARENA_COMPACT=1``.  Like the JAX package's CLI it writes
``./data/{game}/...`` and ``./models/{game}/...`` under the working
directory.  ``DIE_E_BF16=1`` runs inference (``learn``'s self-play and
gate, ``play``'s model agents) in bfloat16 on the card, as the JAX
package's does on the TPU (``core/device.py::compute_dtype``); training
stays float32, and the CPU float32.

Several processes (``learn`` only): start one per card, each with the same
``--coordinator`` and ``--num-processes`` and its own ``--process-id`` (or
under torchrun, which sets them); each process other than 0 writes its
metrics to ``<--metrics-jsonl>.p{rank}``.

Usage:  python -m die_e_tpu_torch.cli.main -g backgammon learn
"""

from __future__ import annotations

import argparse
import sys

def _get_env(name: str):
    if name == "backgammon":
        from die_e_tpu_torch.envs import backgammon as g
    else:
        from die_e_tpu_torch.envs import tictactoe as g
    return g


def _agent(kind: str, model_path, env_mod, dev):
    from die_e_tpu_torch.arena.versus import Agent, Player
    from die_e_tpu_torch.core.device import compute_dtype
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train.learner import net_eval_fn

    kind = kind.lower()
    if kind in ("random", "mcts"):
        return Player(Agent(kind))
    if kind == "model":
        path = model_path or ckpt.best_model_path(env_mod.SPEC.name)
        if not model_path and not path.exists():
            raise SystemExit(f"model agent requested but no model at {path}; "
                             "pass --model1-path/--model2-path")
        return Player(Agent.MODEL, net_eval_fn(ckpt.load_net(path, env_mod.SPEC, dev),
                                               compute_dtype(dev)))
    raise SystemExit(f"unknown agent kind {kind!r} (random|mcts|model)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="die-e-tpu-torch",
        description="AlphaZero for Backgammon (and TicTacToe) on PyTorch/CUDA",
    )
    p.add_argument("-c", "--config", default=None, help="TOML config path")
    p.add_argument("-g", "--game", default="backgammon",
                   choices=["backgammon", "tictactoe"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cuda needs a card; there is no fallback)")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="processes on the data axis: the process count, or -1")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="the model axis; only 1 is supported")
    p.add_argument("--coordinator", default=None,
                   help="process 0's host:port (or a tcp:// or file:// URL) that the "
                        "processes of a multi-process learn meet at")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the group (one per card)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the group")
    p.add_argument("--compact-self-play", action="store_true",
                   help="re-pack live self-play games as games finish")
    p.add_argument("--compact-arena", action="store_true",
                   help="re-pack live arena games as games finish (gate and play)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-jsonl", default=None,
                   help="append structured metric events to this JSONL file")
    sub = p.add_subparsers(dest="command", required=True)

    pl = sub.add_parser("learn", help="run the self-play learn loop")
    pl.add_argument("-m", "--model-path", default=None)
    pl.add_argument("--resume", action="store_true",
                    help="resume from the latest full train state (incl. optimizer)")

    pp = sub.add_parser("play", help="arena match between two agents")
    pp.add_argument("-1", "--agent-one", required=True, help="random|mcts|model")
    pp.add_argument("-2", "--agent-two", required=True, help="random|mcts|model")
    pp.add_argument("--model1-path", default=None)
    pp.add_argument("--model2-path", default=None)
    pp.add_argument("-o", "--output-path", default=None,
                    help="directory for JSON game records")
    pp.add_argument("--num-games", type=int, default=None)

    pt = sub.add_parser("train", help="offline training from saved data")
    pt.add_argument("-m", "--model-path", default=None)
    pt.add_argument("-o", "--out-path", default=None)
    pt.add_argument("-r", "--run-id", default=None)
    pt.add_argument("-l", "--learn", dest="learn_idx", default=None)
    pt.add_argument("-s", "--self-play", dest="sp_idx", default=None)

    pr = sub.add_parser("replay", help="replay a recorded game")
    pr.add_argument("game_path")
    pr.add_argument("--no-wait", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from die_e_tpu_torch.parallel.multihost import initialize_multihost

    cluster = initialize_multihost(args.coordinator, args.num_processes,
                                   args.process_id, device=args.device)
    try:
        return _run(args, cluster)
    finally:
        if cluster is not None:
            cluster.close()


def _run(args, cluster) -> int:
    import dataclasses

    import torch

    from die_e_tpu_torch.core.config import load_config
    from die_e_tpu_torch.core.device import resolve_device
    from die_e_tpu_torch.core.metrics import Metrics

    if cluster is not None and args.command != "learn":
        raise SystemExit(f"{args.command} runs in one process; only learn runs on several")
    dev = cluster.device if cluster is not None else resolve_device(args.device)
    # every process logs, each to its own file (concurrent appends interleave)
    if args.metrics_jsonl and cluster is not None and cluster.rank != 0:
        args.metrics_jsonl = f"{args.metrics_jsonl}.p{cluster.rank}"
    config = load_config(args.config)
    mesh = config.mesh
    if args.mesh_data is not None:
        mesh = dataclasses.replace(mesh, data=args.mesh_data)
    if args.mesh_model is not None:
        mesh = dataclasses.replace(mesh, model=args.mesh_model)
    config = dataclasses.replace(config, mesh=mesh)
    env_mod = _get_env(args.game)
    env = env_mod.ENV
    metrics = Metrics(jsonl_path=args.metrics_jsonl)

    if args.command == "learn":
        from die_e_tpu_torch.train.learn import learn

        learn(env, config, seed=args.seed, model_path=args.model_path,
              metrics=metrics, resume=args.resume, device=dev, cluster=cluster,
              compact_self_play=args.compact_self_play,
              compact_arena=args.compact_arena)

    elif args.command == "play":
        from die_e_tpu_torch.arena.versus import play

        p1 = _agent(args.agent_one, args.model1_path, env_mod, dev)
        p2 = _agent(args.agent_two, args.model2_path, env_mod, dev)
        result = play(
            env, p1, p2, torch.Generator(device=dev).manual_seed(args.seed),
            config.mcts, temperature=config.alphazero.temperature,
            num_games=args.num_games or config.arena.num_games,
            round_limit=config.arena.round_limit, record=args.output_path is not None,
            metrics=metrics, compact=args.compact_arena,
        )
        print(result)
        if args.output_path:
            from die_e_tpu_torch.arena.records import save_game

            for rec in result.games:
                save_game(rec, args.output_path)
            print(f"saved {len(result.games)} game records to {args.output_path}")

    elif args.command == "train":
        from die_e_tpu_torch.train.learn import train_offline

        # ./data/{game}[/run-{id}[/lrn-{i}[/sp-{j}]]]
        data_path = f"./data/{env.spec.name}"
        if args.run_id:
            data_path += f"/run-{args.run_id}"
            if args.learn_idx is not None:
                data_path += f"/lrn-{args.learn_idx}"
                if args.sp_idx is not None:
                    data_path += f"/sp-{args.sp_idx}"
        train_offline(env, config, data_path, seed=args.seed,
                      model_path=args.model_path, out_path=args.out_path,
                      metrics=metrics, device=dev)

    elif args.command == "replay":
        from die_e_tpu_torch.arena.records import replay_game

        replay_game(env, args.game_path, env_mod.pretty_str,
                    wait_user_input=not args.no_wait, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
