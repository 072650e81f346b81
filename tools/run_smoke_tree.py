#!/usr/bin/env python3
"""Run another tree's chip_smoke.py, reporting instead of stopping at the
failures named with --known, so that a parent commit's kernels are timed
on every row of this tree's checks even where the parent is known to fail
one of them:

    git archive <parent> | tar -x -C build/parent
    cp chip_smoke.py build/parent/
    python3 tools/run_smoke_tree.py build/parent \\
        --known "bp_gstep int8 bits=on/silu" -- --phases device,build,kernels

A failure whose message starts with a --known prefix is printed as "KNOWN
FAILURE (not stopped)" and the run goes on; any other failure stops it as
chip_smoke.py does.  The arguments after -- go to chip_smoke.py.  This is
for comparing trees: chip_smoke.py run on its own stops at every failure.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", help="root of the tree whose chip_smoke.py runs")
    ap.add_argument("--known", action="append", default=[],
                    help="message prefix of a failure to report, not stop at")
    argv = list(sys.argv[1:] if argv is None else argv)
    # everything after the first "--" goes to chip_smoke.py as it is
    cut = argv.index("--") if "--" in argv else len(argv)
    args, rest = ap.parse_args(argv[:cut]), argv[cut + 1:]
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    stop = cs.require

    def require(cond, msg):
        if not cond and any(msg.startswith(k) for k in args.known):
            cs.say(f"KNOWN FAILURE (not stopped): {msg}")
            return
        stop(cond, msg)

    cs.require = require
    try:
        return cs.main(rest)
    except cs.SmokeFailure as e:
        cs.say(f"FAILED: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
