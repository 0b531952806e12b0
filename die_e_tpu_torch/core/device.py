"""Device and numerics policy of the port, stated once.

* Compute is float32, as in the JAX package (``core/mesh.py::compute_dtype``
  defaults to f32; DIVERGENCES row 22).  Inference may opt in to bfloat16
  on the card with ``DIE_E_BF16=1`` (:func:`compute_dtype`); training is
  float32 always.
* TF32 is allowed for both matmuls and cuDNN convolutions.  The reference
  ran its f32 convolutions through the TPU's bf16 matrix unit with f32
  accumulation (default XLA precision); TF32 keeps 10 mantissa bits to
  bf16's 7, so the port is at least as precise as the reference on its
  chip, and the 256x19 ResNet runs on the tensor cores.
* The search tree's prior store is bfloat16 (``die_e_tpu/search/tree.py``
  keeps it so): it is the only ``[B, N, A]``-sized array.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
When CUDA is absent and the CPU was not asked for, they raise; they never
fall back quietly.
"""

from __future__ import annotations

import os

import torch

COMPUTE_DTYPE = torch.float32
PRIOR_DTYPE = torch.bfloat16


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    Sets the TF32 policy above whenever the device is CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(device) -> torch.dtype:
    """The inference compute dtype on ``device``: bfloat16 when
    ``DIE_E_BF16=1`` and the device is CUDA, float32 otherwise (so the CPU
    stays float32).  The port of ``die_e_tpu/core/mesh.py::compute_dtype``,
    whose bf16 needs the TPU.  The net keeps float32 parameters and
    BatchNorm either way (``nets/resnet.py``)."""
    if os.environ.get("DIE_E_BF16", "0") == "1" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return COMPUTE_DTYPE
