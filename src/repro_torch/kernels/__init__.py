"""Hand-written CUDA kernels for Hopper (``csrc/``), built at first use
(``build``), with their plain PyTorch versions (``ref``), tile choice
(``autotune``) and wrappers (``ops``)."""
