"""Run one cell of the benchmark (`BENCHMARK.json`) on the card:

    python3 sfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output, and the numbers
the check compared, each with its limit, as the last lines of standard
error.  Exits non-zero without a card, without the program, or when a
forbidden module (jax, jaxlib, flax, repro) was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel build and any compiler cache: fixed directories
# inside the checkout (the kernels' build directory defaults to this one)
for var, sub in (("REPRO_CACHE_DIR", "build/repro_torch_kernels"),
                 ("TRITON_CACHE_DIR", "build/triton"),
                 ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
    os.environ[var] = str(ROOT / sub)
# the checkout's root (for `sfbench`) and its `src` (for the program), in
# place of this script's own directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from sfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
