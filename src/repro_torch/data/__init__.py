"""Pattern datasets of the associative-memory benchmark (``data.patterns``)."""

from repro_torch.data.patterns import (  # noqa: F401
    DATASET_SHAPES,
    corrupt,
    corrupt_batch,
    load_dataset,
)
