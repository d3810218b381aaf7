"""HotSwap: install freshly trained weights into a live engine (the port of
``repro.train.hotswap``).

The train → serve seam.  A :class:`HotSwap` is bound to one engine workload
(a :class:`repro_torch.engine.adapters.RetrievalEngineSolver` instance);
calling :meth:`install` quantizes trained shadow weights to the workload's
serving format and pushes them through ``engine.hot_swap`` — on a
:class:`repro_torch.serving.scheduler.ContinuousEngine` that lands at a
settle-chunk boundary (in-flight slabs finish on the old weights, post-swap
traffic equals a cold restart on the new ones); the solver's config and
launch plans are unchanged.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core import dynamics, quantization
from repro_torch.train import doi

WeightsLike = Union[torch.Tensor, dynamics.OnnParams, quantization.QuantizedWeights]


class HotSwap:
    """Installs trained weights into one live engine workload.

    Accepts float shadow weights straight out of
    :func:`repro_torch.train.doi.train_doi` (quantized here to the solver's
    ``weight_bits``), an already quantized :class:`QuantizedWeights`, or
    ready :class:`OnnParams`.
    """

    def __init__(self, engine: Any, workload: str = "retrieval") -> None:
        self.engine = engine
        self.workload = workload
        self.swaps = 0
        # Fail fast if the workload can't take a swap at all.
        solver = engine.solver(workload)
        if not hasattr(solver, "install_params"):
            raise TypeError(
                f"workload {workload!r} does not support hot weight install"
            )

    @property
    def config(self) -> dynamics.ONNConfig:
        return self.engine.solver(self.workload).config

    @property
    def device(self) -> torch.device:
        """Where the workload's weights live (training runs there too)."""
        return self.engine.solver(self.workload).device

    def install(
        self, weights: WeightsLike, bias: Optional[Any] = None
    ) -> Tuple[dynamics.OnnParams, Optional[quantization.QuantizedWeights]]:
        """Quantize (if needed) and hot-install; returns what was installed."""
        cfg = self.config
        qw: Optional[quantization.QuantizedWeights] = None
        if isinstance(weights, dynamics.OnnParams):
            if bias is not None:
                raise TypeError("bias only applies when weights are not OnnParams")
            params = weights
        elif isinstance(weights, quantization.QuantizedWeights):
            if weights.bits != cfg.weight_bits:
                raise ValueError(
                    f"{weights.bits}-bit weights for a {cfg.weight_bits}-bit solver"
                )
            qw = weights
            params = dynamics.make_params(cfg, weights.values, bias, device=self.device)
        else:
            w = torch.as_tensor(weights).to(torch.float32)
            qw = quantization.quantize_weights(w, cfg.weight_bits)
            params = dynamics.make_params(cfg, qw.values, bias, device=self.device)
        self.engine.hot_swap(self.workload, params)
        self.swaps += 1
        return params, qw

    def train_and_install(
        self,
        xi: Any,
        config: Optional[doi.TrainConfig] = None,
        *,
        lr: Optional[float] = None,
    ) -> doi.TrainResult:
        """Train QAT-DO-I on ``xi`` (on the workload's device) and hot-install
        the result.

        Defaults to quantization-aware training at the solver's own weight
        width, so the installed margins are the margins that were trained.
        """
        tc = config or doi.TrainConfig(qat_bits=self.config.weight_bits)
        result = doi.train_doi(xi, tc, lr=lr, device=self.device)
        self.install(result.weights)
        return result
