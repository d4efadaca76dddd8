"""A later change adds a configuration, a traffic mix, a cell and a metric
as new files and new entries of BENCHMARK.json; the harness runs it with
no file that is there edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from _small import MOVIE, ROOT

DUMMY_CONFIG = {'source': 'the deployed bundle under another name',
                'bundle': 'deployed_model', 'overrides': {},
                'weights': 'bundle', 'reduced': []}
DUMMY_METRIC = '''"""calls_done: the calls made in the window."""


def read(rec):
    return float(len(rec['calls'])) if 'calls' in rec else None
'''


def digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if '__pycache__' not in d:
                p = os.path.join(d, f)
                with open(p, 'rb') as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_config_mix_and_metric_run_as_added_files(tmp_path):
    root = tmp_path / 'checkout'
    root.mkdir()
    shutil.copytree(f'{ROOT}/portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(f'{ROOT}/BENCHMARK.json', root)
    for name in ('axtrack_tpu_torch', 'deployed_model'):
        os.symlink(f'{ROOT}/{name}', root / name)
    before = digests(root / 'portbench')

    pb = root / 'portbench'
    (pb / 'configs' / 'dummy_tiny.json').write_text(
        json.dumps(DUMMY_CONFIG))
    with open(pb / 'traffic' / 'movie20.json') as f:
        mix = dict(json.load(f), **MOVIE)
    (pb / 'traffic' / 'dummy_small.json').write_text(json.dumps(mix))
    (pb / 'metrics' / 'calls_done.py').write_text(DUMMY_METRIC)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'dummy_tiny', 'source': 'test',
                             'file': 'portbench/configs/dummy_tiny.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': 'dummy.small', 'config': 'dummy_tiny',
                               'traffic': 'dummy_small', 'chips': 1,
                               'why': 'test'})
    bench['end_to_end'].append({'name': 'calls_done', 'unit': 'calls',
                                'better': 'higher', 'bound': 0.25,
                                'source': 'host_clock',
                                'workloads': ['dummy.small']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    code = ('import sys, json, time; sys.path.insert(0, ".")\n'
            'from portbench.lib import harness\n'
            'out = harness.run(".", "dummy.small", 11, 0.3, 0, "cpu", '
            'time.perf_counter(), log=lambda *a: None)\n'
            'print(json.dumps(out))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['metrics']['calls_done']['value'] >= 1
    # infer_fps and movie_p90_ms list their cells: not this one
    assert set(out['metrics']) == {'setup_s', 'calls_done'}
    after = digests(root / 'portbench')
    assert {p: after[p] for p in before} == before
