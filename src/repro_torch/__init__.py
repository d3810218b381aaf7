"""PyTorch/CUDA port of the digital ONN reproduction.

A second package beside the JAX reference (``repro``), mirroring its layout:
``core/`` (oscillator, quantization, coupling, learning, dynamics),
``kernels/`` (hand-written CUDA kernels for Hopper, their plain PyTorch
versions and wrappers), ``configs/``, ``data/``, ``checkpoint/``,
``convert.py`` and ``api.py``.  It imports ``torch`` and numpy, never
``jax`` or ``repro``.  Entry points place tensors on the GPU unless the
caller passes ``device="cpu"``.
"""
