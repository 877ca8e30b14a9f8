"""``python -m repro_torch.lint [paths]``."""
import sys

from repro_torch.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
