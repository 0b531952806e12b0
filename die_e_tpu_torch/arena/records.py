"""JSON game records and their replay: the port of
``die_e_tpu/arena/records.py``.

One JSON file per game, ``{id, game, player1, player2, turns: [{roll,
action, player}], winner, initial_state}``, the same JSON field for field
as the JAX package's, so that a record written by either package replays
in the other.  ``initial_state`` holds the state's fields as lists; the
backgammon dice seed is written as its non-negative uint32 value and the
doubles flag ``second`` as a JSON bool.

The replay re-applies every turn's action to the board (the JAX package's
documented fix of the reference's replay, which showed the initial board
after every turn).
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Turn:
    roll: Optional[list]
    action: int
    player: str  # the agent kind of the side that moved

    def to_json(self):
        return {"roll": self.roll, "action": self.action, "player": self.player}

    @staticmethod
    def from_json(d):
        return Turn(roll=d["roll"], action=d["action"], player=d["player"])


@dataclasses.dataclass
class GameRecord:
    id: str
    player1: str
    player2: str
    turns: List[Turn]
    winner: str
    initial_state: dict  # the state's fields of this game, as lists
    game: str = ""

    def to_json(self):
        return {
            "id": self.id,
            "game": self.game,
            "player1": self.player1,
            "player2": self.player2,
            "turns": [t.to_json() for t in self.turns],
            "winner": self.winner,
            "initial_state": self.initial_state,
        }

    @staticmethod
    def from_json(d):
        return GameRecord(
            id=d["id"],
            game=d.get("game", ""),
            player1=d["player1"],
            player2=d["player2"],
            turns=[Turn.from_json(t) for t in d["turns"]],
            winner=d["winner"],
            initial_state=d["initial_state"],
        )

    @staticmethod
    def from_arrays(env, p1_kind, p2_kind, init_states, turns_log, winner):
        """Per-game records from the arena's round log: ``init_states`` is
        the batched initial state, ``turns_log`` one ``(player_sign [B],
        action [B] (-1 where the game was already over), roll [B, 2] or
        None)`` of numpy arrays per round, ``winner`` [B]."""
        state_fields = {
            f.name: np.asarray(getattr(init_states, f.name).cpu())
            for f in dataclasses.fields(init_states)
        }
        records = []
        for g in range(len(winner)):
            turns = []
            for player_sign, action, roll in turns_log:
                if action[g] < 0:
                    continue  # the game was already over this round
                kind = p1_kind.value if player_sign[g] == -1 else p2_kind.value
                roll_g = roll[g].tolist() if roll is not None else None
                turns.append(Turn(roll=roll_g, action=int(action[g]), player=kind))
            w = int(winner[g])
            winner_kind = p1_kind.value if w == -1 else p2_kind.value if w == 1 else "none"
            records.append(GameRecord(
                id=uuid.uuid4().hex[:21],
                game=env.spec.name,
                player1=p1_kind.value,
                player2=p2_kind.value,
                turns=turns,
                winner=winner_kind,
                initial_state={k: v[g].tolist() for k, v in state_fields.items()},
            ))
        return records


def save_game(record: GameRecord, game_path) -> Path:
    """Write ``{id}.json`` under ``game_path``."""
    path = Path(game_path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"{record.id}.json"
    out.write_text(json.dumps(record.to_json(), indent=2))
    return out


def load_game(path) -> GameRecord:
    return GameRecord.from_json(json.loads(Path(path).read_text()))


def load_all_games(path) -> List[GameRecord]:
    return [
        load_game(p) for p in sorted(Path(path).iterdir())
        if p.is_file() and p.suffix == ".json"
    ]


def _state_from_record(env, record: GameRecord, device):
    """The record's initial state as a one-game batch on ``device``, each
    field in the dtype of the port's state."""
    template = env.init(torch.zeros(1, dtype=torch.int64), device=device)
    fields = {
        f.name: torch.as_tensor(np.asarray(record.initial_state[f.name]), device=device)
        .to(getattr(template, f.name).dtype)[None]
        for f in dataclasses.fields(template)
    }
    return type(template)(**fields)


def replay_game(env, path, pretty_str, wait_user_input: bool = False, out=print,
                device="cpu"):
    """Print the game recorded at ``path``, re-applying every turn's action
    to the board on ``device``; returns the final one-game state."""
    record = load_game(path)
    out(f"Game ID: {record.id}")
    out(f"Player 1: {record.player1}, Player 2: {record.player2}")
    out(f"Game winner: {record.winner}")
    state = _state_from_record(env, record, device)
    out("Initial State:")
    out(pretty_str(state))
    for turn in record.turns:
        out(f"Player: {turn.player}")
        out(f"Roll: {turn.roll}")
        out(f"Action: {turn.action}")
        state = env.step(state, torch.tensor([turn.action], dtype=torch.int32, device=device))
        out("State after action has been played:")
        out(pretty_str(state))
        if wait_user_input:
            input("Press Enter to continue...")
    return state
