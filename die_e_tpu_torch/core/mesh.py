"""The mesh of the port: the port's counterpart of ``die_e_tpu/core/mesh.py``.

The JAX package builds a ``(data, model)`` device mesh inside one program.
The port follows PyTorch's idiom: the mesh is the process group, one
process (rank) per card, and the data axis is the group's size.  The JAX
package replicates the ResNet over the ``model`` axis, so ``model > 1``
changes no result there; the port refuses it rather than run a model axis
it would not use.
"""

from __future__ import annotations

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int = -1, model: int = 1, world_size: int = 1) -> dict:
    """The mesh ``{"data", "model"}`` over a process group of
    ``world_size`` ranks; ``data = -1`` means every rank.  Raises unless
    ``data`` equals ``world_size`` (or is -1) and ``model`` is 1."""
    if model != 1:
        raise ValueError(
            f"mesh model={model}: the port runs one process per card and "
            "replicates the net, so only mesh_model = 1 is supported (the JAX "
            "package's model axis also replicates the net)")
    if data == -1:
        data = world_size
    if data != world_size:
        raise ValueError(
            f"mesh data={data} must equal the number of processes ({world_size}), "
            "one per card, or be -1; start one process per card with "
            "--num-processes/--process-id or torchrun")
    return {DATA_AXIS: data, MODEL_AXIS: model}
