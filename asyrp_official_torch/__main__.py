"""`python -m asyrp_official_torch` → the port's CLI (cli/main.py)."""
import sys

from asyrp_official_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
