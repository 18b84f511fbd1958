"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs as many CUDA cards as the cell asks
for and exits non-zero, printing no result, without them. The last line of
standard output is the result object; the numbers that decided `correct` are
the last lines of standard error, each beside its limit.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compiler caches at fixed paths inside the checkout (the port's nvcc builds
# go to its own build/kernels/ there)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
# one host thread for the CPU's share of the ops: the host only dispatches,
# and idle pool threads spinning beside it make runs spread
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
