"""Run one benchmark cell once and print its result as the last line:

    python3 dcnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository (`python3 -m dcnbench.run`
works the same).  See dcnbench/README.md.
"""
import time

T0 = time.perf_counter()   # set-up is timed from here

import pathlib  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # The checkout's root, not this folder, is where imports start: the
    # benchmark is the package `dcnbench`, and its module names must not
    # shadow the standard library's.
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from dcnbench.harness import main
    sys.exit(main(sys.argv[1:], T0))
