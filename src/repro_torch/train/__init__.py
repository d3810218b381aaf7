"""repro_torch.train: batched quantization-aware DO-I learning + hot weight
install (the port of ``repro.train``).

The training subsystem for the associative-memory workload: a
library-batched Diederich–Opper I trainer that measures stability on the
quantized weights the hardware runs (:mod:`repro_torch.train.doi`), and a
:class:`HotSwap` seam that installs the result into a live engine at a
settle-chunk boundary (:mod:`repro_torch.train.hotswap`).

    from repro_torch import train

    result = train.train_doi(xi, train.TrainConfig(qat_bits=5))  # on the GPU
    params, qw = train.trained_params(cfg, result.weights)        # cold install
    train.HotSwap(engine).install(result.weights)                 # hot install
"""

from repro_torch.train.doi import TrainConfig, TrainResult, train_doi, trained_params
from repro_torch.train.hotswap import HotSwap

__all__ = [
    "TrainConfig",
    "TrainResult",
    "train_doi",
    "trained_params",
    "HotSwap",
]
