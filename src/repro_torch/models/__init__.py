"""The LM model zoo (the port of ``repro.models``): the dense, MoE and VLM
decoder-only families.

``config`` (``ModelConfig``, the shape cells), ``params`` (``ParamSpec``
trees and their materialization from a ``torch.Generator``), ``layers``
(norms, RoPE, blocked attention, gated cross-attention, SwiGLU, the MoE),
``transformer`` (the decoder assembly, its KV cache, prefill and decode),
``model`` (``get_model``) and ``steps`` (the serving steps and
``make_generate``).  The encoder-decoder, Zamba and xLSTM families wait for
ROADMAP.md, section 1, item 5.
"""
