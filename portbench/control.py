"""Readings for the limits of the output check (not part of a benchmark
run): for each seed, one run of the cell (a short window) whose check
also reads the control, the reference at TF32 in the program's place
(and, for the training cell, a fault planted in the reference: half of
each batch left out). Prints one JSON line a seed:

    python3 portbench/control.py --workload <name> --seconds 3 \
        --seeds 11 12 13
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=3)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.lib import harness
    for seed in args.seeds:
        out = harness.run(ROOT, args.workload, seed, args.seconds, 0,
                          'cuda', time.perf_counter(), control=True,
                          log=lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({'seed': seed, 'correct': out['correct'],
                          'checks': out['checks'], 'notes': out['notes'],
                          'metrics': out['metrics']}, default=str),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
