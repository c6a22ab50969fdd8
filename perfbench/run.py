"""The benchmark of resuneta_torch on one NVIDIA H100:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. See harness/main.py and PERF.md."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the build and kernel caches live at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
# no library of the run may load JAX on its own
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
