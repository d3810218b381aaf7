"""``python -m repro_torch.analysis`` — the ``repro-torch-lint`` console entry."""

import sys

from repro_torch.analysis.core import main

if __name__ == "__main__":
    sys.exit(main())
