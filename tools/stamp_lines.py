#!/usr/bin/env python3
"""Time the phases of a long script from its output: copy standard input
to a file unchanged, and write each line to standard error prefixed by
the seconds since the filter started (cut to 200 characters).

    set -o pipefail
    python3 chip_smoke.py | python3 tools/stamp_lines.py smoke.log \
        2> smoke_stamped.log

``chip_smoke.py`` prints one JSON row as each check or phase ends, so
the stamp of a row is when its phase finished.
"""
from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: stamp_lines.py RAW_OUTPUT_FILE", file=sys.stderr)
        return 2
    t0 = time.time()
    with open(args[0], "w") as raw:
        for line in sys.stdin:
            raw.write(line)
            raw.flush()
            sys.stderr.write(f"{time.time() - t0:9.1f} "
                             f"{line.rstrip()[:200]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
