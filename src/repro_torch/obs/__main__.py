"""``python -m repro_torch.obs TRACE.json [--expect-async-overlap]`` —
validate a saved trace (the CLI of ``repro_torch.obs.trace``, without the
runpy double-import warning that ``-m repro_torch.obs.trace`` triggers)."""

import sys

from repro_torch.obs.trace import main

if __name__ == "__main__":
    sys.exit(main())
