"""Batched LM serving on the PyTorch/CUDA port: prefill, then token-by-token
decode against the KV/state cache.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch xlstm-1.3b] [--device cpu]

Serves a reduced config through ``repro_torch.launch.serve`` (the
continuous serving daemon over the ``"lm"`` engine workload) and prints its
report.  Zamba and xLSTM take prompts of whole SSD chunks, so the prompt
length is the config's ``ssm_chunk`` for them.  Runs on the card unless
``--device cpu``.
"""

import argparse
import json

from repro_torch import configs
from repro_torch.launch.serve import serve


def main(arch: str = "xlstm-1.3b", batch: int = 4, tokens: int = 16, device=None) -> dict:
    cfg = configs.get_reduced(arch)
    prompt = cfg.ssm_chunk if cfg.family in ("zamba", "xlstm") else 32
    out = serve(arch, batch=batch, prompt_len=prompt, max_new_tokens=tokens, device=device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(args.arch, args.batch, args.tokens, args.device)
