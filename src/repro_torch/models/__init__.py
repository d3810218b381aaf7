"""The LM model zoo (the port of ``repro.models``): every family of the
reference — the dense, MoE and VLM decoders, the Whisper-style
encoder-decoder, the Zamba hybrid and xLSTM.

``config`` (``ModelConfig``, the shape cells), ``params`` (``ParamSpec``
trees and their materialization from a ``torch.Generator``), ``layers``
(norms, RoPE, blocked attention, gated cross-attention, SwiGLU, the GELU
MLP, the MoE), ``transformer`` (the decoder assembly, its KV cache, prefill
and decode), ``encdec`` (the encoder-decoder), ``ssm`` (Mamba2's SSD),
``xlstm`` (the mLSTM and sLSTM blocks), ``hybrid`` (the Zamba and xLSTM
assemblies), ``model`` (``get_model``) and ``steps`` (the serving steps,
``make_generate``, the train step and ``build_cell``, the dry run's cell).
"""
