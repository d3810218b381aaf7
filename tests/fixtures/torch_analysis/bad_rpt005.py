"""RPT005 fixture: TF32 switched on for float32 products."""

import torch

torch.backends.cuda.matmul.allow_tf32 = True
torch.set_float32_matmul_precision("high")
