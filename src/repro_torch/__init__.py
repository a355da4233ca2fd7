"""PyTorch + CUDA port of the LM substrate of ``repro`` for NVIDIA Hopper.

Mirrors ``src/repro/``'s layout (``configs/``, ``models/``, ``kernels/``,
``launch/``) so each module's JAX counterpart is found by path.  Imports
``torch``, never ``jax``, and nothing of the ``repro`` package.  Entry points
run on ``device="cuda"`` unless the caller passes ``device="cpu"``; on CPU
tensors each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
