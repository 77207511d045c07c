"""Run one cell of BENCHMARK.json once (see ``portbench/harness.py``).

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, so that these modules do not
# shadow the standard library's (``trace``)
sys.path[0] = str(ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
