"""The LM model zoo (the port of ``repro.models``): the dense decoder-only
family first.

``config`` (``ModelConfig``, the shape cells), ``params`` (``ParamSpec``
trees and their materialization from a ``torch.Generator``), ``layers``
(norms, RoPE, blocked attention, SwiGLU), ``transformer`` (the dense
assembly, its KV cache, prefill and decode), ``model`` (``get_model``) and
``steps`` (the serving steps and ``make_generate``).  The MoE, VLM,
encoder-decoder, Zamba and xLSTM families wait for ROADMAP.md, section 1,
item 5.
"""
