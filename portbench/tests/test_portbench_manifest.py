"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and the time a full check takes."""
import json
import os
import re
from types import SimpleNamespace

from _small import ROOT
from portbench.lib import config
from portbench.reference import model as M

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PB = os.path.join(ROOT, 'portbench')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['command'] == ['python3', 'portbench/run.py']
    assert b['paths'] == ['portbench']
    assert isinstance(b['run_seconds'], int) and 1 <= b['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c['name'] for c in b['configs']]
    names += [w['name'] for w in b['workloads']]
    names += [m['name'] for m in b['end_to_end'] + b['per_layer']]
    names += [w[k] for w in b['workloads'] for k in ('config', 'traffic')]
    names += [k for c in b['configs'] for k in c['reduced']]
    for n in names:
        assert NAME.match(n), n
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for group in ('configs', 'workloads'):
        got = [x['name'] for x in b[group]]
        assert len(got) == len(set(got))
    metrics = [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(metrics) == len(set(metrics))


def test_entries_have_just_their_keys():
    b = bench()
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in b['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}


def test_every_name_finds_its_files():
    b = bench()
    for c in b['configs']:
        assert c['file'].startswith('portbench/')
        assert os.path.exists(os.path.join(ROOT, c['file']))
        with open(os.path.join(ROOT, c['file'])) as f:
            ctx = SimpleNamespace(root=ROOT, config=json.load(f))
        arch = M.architecture(config.params_json(ctx))
        assert os.path.exists(os.path.join(PB, 'reference', 'trunks',
                                           f'{arch}.py')), (c['name'], arch)
    for w in b['workloads']:
        assert os.path.exists(os.path.join(PB, 'traffic',
                                           f'{w["traffic"]}.json'))
    for m in b['end_to_end'] + b['per_layer']:
        assert os.path.exists(os.path.join(PB, 'metrics',
                                           f'{m["name"]}.py')), m['name']


def test_a_calibration_names_an_inference_mix_of_seeded_weights():
    for c in bench()['configs']:
        with open(os.path.join(ROOT, c['file'])) as f:
            conf = json.load(f)
        if 'calibration' not in conf:
            continue
        assert conf['weights'] == 'seeded', c['name']
        path = os.path.join(PB, 'traffic', f'{conf["calibration"]}.json')
        assert os.path.exists(path), (c['name'], path)
        with open(path) as f:
            assert json.load(f)['entry'] == 'infer', c['name']


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    b = bench()
    e2e = {m['name']: m for m in b['end_to_end']}
    assert 'setup_s' in e2e
    for w in b['workloads']:
        mine = [m for m in b['end_to_end']
                if w['name'] in m.get('workloads', [w['name']])]
        assert 'setup_s' in [m['name'] for m in mine] and len(mine) >= 2
        layer = [m for m in b['per_layer']
                 if w['name'] in m.get('workloads', [w['name']])]
        assert layer
        for m in layer:
            moved = e2e[m['moves']]
            assert w['name'] in moved.get('workloads', [w['name']])


def test_a_full_check_fits_its_time():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200
