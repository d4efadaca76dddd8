"""The benchmark of the PyTorch/CUDA port (axtrack_tpu_torch) on one cell:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. It measures on the CUDA card(s) of the
machine it runs on and exits non-zero, printing no result, without as
many cards as the cell asks for. The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number the output check compared beside its limit. See
``lib/harness.py`` for what a run does.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age():
    """Seconds between the process's start and now, from /proc (0 where
    there is none)."""
    try:
        with open('/proc/self/stat') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None):
    t0 = T0 - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.lib import harness
    _, cell, _, _ = harness.cell_of(ROOT, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell['chips'])):
        print(f'needs {cell["chips"]} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ': no result', file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      args.trace, 'cuda', t0, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f'loaded modules it must not: {bad}: no result')
        return 3
    sys.stdout.flush()
    for name, c in out['checks'].items():
        log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
