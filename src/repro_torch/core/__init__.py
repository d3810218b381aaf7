"""Simulation core of the port: oscillator semantics, quantization, coupling
arithmetic, learning rules, the functional-mode dynamics and the energy
model.  Re-exports the names that ``repro.core`` re-exports."""

from repro_torch.core.dynamics import (  # noqa: F401
    BACKENDS,
    ONNConfig,
    ONNResult,
    OnnParams,
    OnnState,
    async_sweep,
    functional_update,
    init_state,
    initial_phase,
    make_params,
    retrieve,
    run,
    run_batch,
    sign_update,
    step,
    validate_weights,
    weighted_sum,
)
from repro_torch.core.quantization import (  # noqa: F401
    QuantizedWeights,
    quantize_weights,
    pack_int4,
    unpack_int4,
)
from repro_torch.core.learning import diederich_opper_i, hebbian  # noqa: F401
from repro_torch.core.energy import hamiltonian, is_local_minimum  # noqa: F401
