"""One run of one cell of the benchmark of ``ideepcolor_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object),
and each number the check compared, beside its limit, as the last lines of
standard error. Run from the root of a checkout; it exits with another code
than 0, and prints no result, without a CUDA device."""

import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
# kernel and JIT caches at fixed paths inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(_ROOT / "build" / "cuda_cache"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(_ROOT))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
