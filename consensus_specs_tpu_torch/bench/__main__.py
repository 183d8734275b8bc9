"""``python -m consensus_specs_tpu_torch.bench``: see ``bench/entry.py``."""
import sys

from .entry import main

if __name__ == "__main__":
    sys.exit(main())
