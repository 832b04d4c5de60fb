#!/usr/bin/env python3
"""Run one cell of the benchmark once (see benchmark/__init__.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Exit code 0 with a JSON line last on stdout; any other code prints none.
"""

import os
import sys
import traceback

# the checkout's root, not the script's directory, on the path: nothing
# under benchmark/ may shadow a module of the standard library
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    try:
        from benchmark import use_checkout_caches

        use_checkout_caches()
        from benchmark.harness import main

        code = main()
    except Exception:                                      # noqa: BLE001
        traceback.print_exc()
        code = 1
    sys.exit(code)
