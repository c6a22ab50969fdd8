"""The benchmark's own tests, apart from the repository's tests/:

    python -m pytest perfbench/tests -q            # CPU
    python -m pytest perfbench/tests -q -m gpu     # on the card

They import the harness the way perfbench/run.py does."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
