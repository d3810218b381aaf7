"""Simulation core of the port: oscillator semantics, quantization, coupling
arithmetic, learning rules and the functional-mode dynamics."""
