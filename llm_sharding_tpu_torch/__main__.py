"""``python -m llm_sharding_tpu_torch <command>`` (``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
