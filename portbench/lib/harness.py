"""One run of one cell, driven by ``BENCHMARK.json``.

Everything that belongs to a cell is found by name: the workload's
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, which names the entry that drives the window,
``entries/<entry>.py``), the reference trunk of its configuration's
architecture (``reference/trunks/<name>.py``, found by
``reference/model.py``) and, for every metric the cell reports, its
reader ``metrics/<metric>.py``. Adding a cell, a configuration, a mix, a
metric or an architecture's reference trunk adds files and entries; no
file here names one.

A run: set-up (the entry's, timed from process start as ``setup_s``, less
the seconds of a configuration's calibration, ``lib/config.py``), the
measured window, with ``--trace 1`` a short profiled span after it, the
peak device memory, the program's state freed, then the reference's
comparison of the window's outputs (``lib/check.py``), then the metrics.
"""
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import check, config
from ..reference import model as M

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'orbax', 'axtrack_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one the port must not load."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(root, workload):
    """(BENCHMARK.json, the workload, its configuration, its mix)."""
    bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    cells = [w for w in bench['workloads'] if w['name'] == workload]
    if not cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[0]
    listed = [c for c in bench['configs'] if c['name'] == cell['config']][0]
    conf = load_json(os.path.join(root, listed['file']))
    mix = load_json(os.path.join(HERE, 'traffic', f'{cell["traffic"]}.json'))
    return bench, cell, conf, mix


def metrics_of(bench, workload, trace):
    """The metrics this cell reports: end-to-end ones with ``trace`` 0,
    per-layer ones with 1; a metric with a ``workloads`` list only in
    those."""
    listed = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in listed if workload in m.get('workloads', [workload])]


def entry_of(mix):
    from importlib import import_module
    return import_module(f'portbench.entries.{mix["entry"]}')


def reader(name):
    return load_module(os.path.join(HERE, 'metrics', f'{name}.py'),
                       f'portbench_metric_{name.replace(".", "_")}')


def in_channels(P):
    """The detector's input channels: each context frame's channels."""
    per_frame = {'exclude': 1, 'only': 2, 'include': 3}[P['USE_MOTION_DATA']]
    return per_frame * (2 * P['TEMPORAL_CONTEXT'] + 1)


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    import subprocess
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(root, workload, seed, seconds, trace, device, t0, mix_over=None,
        log=print, control=False):
    """One run; returns the result dict (``correct`` .. ``checks``).
    ``control`` (``control.py``) adds the check's control readings under
    'notes'; the benchmark's runs never read them."""
    bench, cell, conf, mix = cell_of(root, workload)
    mix = dict(mix, **(mix_over or {}))
    tmp = tempfile.mkdtemp(prefix='portbench-')
    ctx = SimpleNamespace(root=root, seed=int(seed), trace=bool(trace),
                          device=torch.device(device), config=conf, mix=mix,
                          tmp=tmp, calibration_s=0.0)
    entry = entry_of(mix)
    cuda = ctx.device.type == 'cuda'
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        st = entry.setup(ctx)
        if cuda:
            torch.cuda.synchronize()
        rec = {'setup_s': time.perf_counter() - t0 - ctx.calibration_s}
        if ctx.calibration_s:
            log(f'calibration: {ctx.calibration_s:.3f} s, not in setup_s')
        rec.update(entry.window(st, seconds, ctx))
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f'loaded modules it must not: {bad}')
        if trace and cuda:
            rec['trace'] = entry.traced(st, ctx)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        entry.free(st)
        gc.collect()
        t_check = time.perf_counter()
        nums, notes = entry.judge(st, ctx, rec, control)
        log(f'reference check: {time.perf_counter() - t_check:.3f} s, '
            f'{notes}')
        P = config.params_json(ctx)
        rec['flops_per_tile'] = M.forward_flops(
            P, in_channels(P), P['TILESIZE'])
        rec['kept_tiles'] = [m['kept_tiles'] for m in st.get('movies', [])]
        metrics = {}
        for m in metrics_of(bench, workload, trace):
            value = reader(m['name']).read(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        checks = {k: {'value': v, 'limit': check.LIMITS[k]}
                  for k, v in nums.items()}
        out = {'correct': all(v['value'] <= v['limit']
                              for v in checks.values()),
               'attempted': rec['attempted'], 'failed': rec['failed'],
               'metrics': metrics,
               'device': {'platform': 'gpu' if cuda else 'cpu',
                          'kind': (torch.cuda.get_device_name(0) if cuda
                                   else 'cpu'),
                          'count': int(cell['chips']),
                          'memory_peak_bytes': int(peak),
                          'power_limit': power_limit() if cuda else None}}
        if trace and rec.get('trace'):
            tr = rec['trace']
            out['device'].update(busy_s=tr['busy_s'],
                                 window_s=tr['window_s'])
            out['breakdown'] = {'device_ops': tr['device_ops'],
                                'idle_gaps': tr['idle_gaps']}
        if control:
            out['notes'] = notes
        out['checks'] = checks
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
