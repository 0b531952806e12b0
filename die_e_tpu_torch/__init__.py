"""die-e-tpu on PyTorch and CUDA: the port of ``die_e_tpu`` to NVIDIA
H100s.

The package mirrors the JAX package's layout (``core/``, ``envs/``,
``nets/``, ``ops/``, ``parallel/``, ``search/``, ``train/``, ``arena/``,
``cli/``; ``entry.py`` for ``__graft_entry__.py``) and is held against it by the
``tests/test_torch_*.py`` files.  It imports ``torch`` and never JAX or the
JAX package.  Functions act on batched ``[B, ...]`` tensors; entry points
take an explicit ``device`` and run on ``cuda`` unless the caller asks for
``"cpu"`` (see :mod:`die_e_tpu_torch.core.device`).

The two row kernels of the search tree (``ops/csrc/rows.cu``) are CUDA C++
for ``sm_90a``, built by ``nvcc`` at first use and loaded with ``ctypes``.
"""

__version__ = "0.1.0"
