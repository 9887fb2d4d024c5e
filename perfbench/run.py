#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It measures the PyTorch and CUDA port
(``src/repro_torch``) on the CUDA card and exits non-zero, printing no
result, without one.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    try:
        import repro_torch  # noqa: F401  the system under test
    except ImportError as e:
        sys.exit(f"the port is not in this checkout: {e}")
    from perfbench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
