"""Hand-written CUDA kernels for Hopper (``csrc/``), built at first use
(``build``), with their plain PyTorch versions (``ref``), tile choice
(``autotune``) and wrappers (``ops``).

The kernel library's public entry points, as ``repro.kernels`` exports
them: :func:`coupling_sum`, :func:`onn_step` and :func:`quantized_matvec`.
"""

from repro_torch.kernels.ops import coupling_sum, onn_step, quantized_matvec  # noqa: F401
