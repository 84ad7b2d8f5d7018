"""``python -m repro_torch.analysis`` — audit the port's discrete-event
executor on the quick scenarios (conservation, snapshot sanity,
determinism under permuted tie-breaks).  Exits nonzero on any finding.

The repo-specific lint is not run here: it stays in the reference package
(``python -m repro.analysis --lint-only``), which lints every file under
``src/``, the port's included.
"""
from __future__ import annotations

import argparse
import sys

from . import audit


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "-k", "--permutations", type=int, default=5, metavar="K",
        help="tie-break permutations per determinism audit (default: 5)",
    )
    args = parser.parse_args(argv)

    report = audit.run_all(k=args.permutations)
    for line in report.lines():
        print(line)
    n_scen = len(audit.QUICK_SCENARIOS)
    print(
        f"audit: {n_scen} scenarios + swap path, "
        f"{args.permutations} tie-break permutations each: "
        + ("ok" if report.ok else "FAILED")
    )
    return int(not report.ok)


if __name__ == "__main__":
    sys.exit(main())
