"""A later change adds a configuration, a traffic mix, a cell, a metric and
an architecture's reference trunk as new files and new entries of
BENCHMARK.json; the harness runs it with no file that is there edited."""
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
ALEXNET_CONFIG = {'source': 'the deployed bundle with the AlexNet backbone',
                  'bundle': 'deployed_model',
                  'overrides': {'ARCHITECTURE': 'alexnet'},
                  'weights': 'seeded', 'weights_seed': 5, 'reduced': []}
# the reference's AlexNet trunk (machinelearning/model.py:55-83: the
# torchvision features with a 3x3 stride-2 padding-2 stem, the 5x5 conv at
# stride 2 and the third conv at padding 2)
ALEXNET_TRUNK = '''"""AlexNet's trunk as the reference builds it."""
import torch
import torch.nn.functional as F

from .. import model as M

# (block, out channels, kernel, stride, padding) of each biased conv and
# ReLU; a 3x3 stride-2 max-pool follows blocks 0, 3 and 10
CONVS = ((0, 64, 3, 2, 2), (3, 192, 5, 2, 2), (6, 384, 3, 1, 2),
         (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))
POOLED = (0, 3, 10)


def from_state_dict(sd, params):
    return [(sd[f'ConvNet.block_{i}.weight'], sd[f'ConvNet.block_{i}.bias'],
             s, p, i in POOLED) for i, _, _, s, p in CONVS]


def shape_net(params, in_channels, tilesize):
    e = lambda *s: torch.empty(s, device='meta')  # noqa: E731
    c, h, convs = in_channels, tilesize, []
    for i, out_c, k, s, p in CONVS:
        convs.append((e(out_c, c, k, k), e(out_c), s, p, i in POOLED))
        c, h = out_c, (h + 2 * p - k) // s + 1
        if i in POOLED:
            h = (h - 3) // 2 + 1
    return convs, c, h


def trunk(net, x, ops, train=False):
    for w, b, s, p, pooled in net:
        x = ops.conv(x, w, b, s, p)
        x = F.relu(x)
        if pooled:
            x = F.max_pool2d(x, 3, 2)
    return x
'''
# the planted fault: the 384-channel conv's ReLU left out
ALEXNET_FAULT = ALEXNET_TRUNK.replace(
    '        x = F.relu(x)\n',
    '        x = x if w.shape[0] == 384 else F.relu(x)\n')


# ResNet-18 on seeded weights whose BatchNorm statistics are calibrated on
# the cell's own mix (lib/config.py)
CALIBRATED_CONFIG = {'source': 'the deployed bundle with the ResNet-18 '
                     'backbone, calibrated', 'bundle': 'deployed_model',
                     'overrides': {'ARCHITECTURE': 'resnet'},
                     'weights': 'seeded', 'weights_seed': 6,
                     'calibration': 'resnet_small',
                     'reduced': []}
# the planted fault: the stem's BatchNorm with eps 1e-3, the slip a
# MobileNet trunk would make
RESNET_STEM = "net['stem_bn'], train, BN_EPS)"
RESNET_FAULT = "net['stem_bn'], train, 1e-3)"


def digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if '__pycache__' not in d:
                p = os.path.join(d, f)
                with open(p, 'rb') as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def checkout(tmp_path):
    """A checkout of the benchmark (the program and the bundle linked)."""
    root = tmp_path / 'checkout'
    root.mkdir()
    shutil.copytree(f'{ROOT}/portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(f'{ROOT}/BENCHMARK.json', root)
    for name in ('axtrack_tpu_torch', 'deployed_model'):
        os.symlink(f'{ROOT}/{name}', root / name)
    return root


def add_cell(root, config, conf, traffic, cell):
    """Writes a configuration file and a movie20-like mix at the test's
    size, and lists both and the cell in BENCHMARK.json."""
    pb = root / 'portbench'
    (pb / 'configs' / f'{config}.json').write_text(json.dumps(conf))
    with open(pb / 'traffic' / 'movie20.json') as f:
        mix = dict(json.load(f), **MOVIE)
    (pb / 'traffic' / f'{traffic}.json').write_text(json.dumps(mix))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': config, 'source': 'test',
                             'file': f'portbench/configs/{config}.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': cell, 'config': config,
                               'traffic': traffic, 'chips': 1,
                               'why': 'test'})
    return bench


def run_cell(root, cell, extra=''):
    """One harness run of ``cell`` on the CPU in a fresh process: its
    result, with whatever ``extra`` adds to ``out``."""
    code = ('import sys, json, time; sys.path.insert(0, ".")\n'
            'from portbench.lib import harness\n'
            f'out = harness.run(".", "{cell}", 11, 0.3, 0, "cpu", '
            'time.perf_counter(), log=lambda *a: None)\n'
            + extra + 'print(json.dumps(out))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_new_cell_config_mix_and_metric_run_as_added_files(tmp_path):
    root = checkout(tmp_path)
    before = digests(root / 'portbench')

    bench = add_cell(root, 'dummy_tiny', DUMMY_CONFIG, 'dummy_small',
                     'dummy.small')
    (root / 'portbench' / 'metrics' / 'calls_done.py').write_text(
        DUMMY_METRIC)
    bench['end_to_end'].append({'name': 'calls_done', 'unit': 'calls',
                                'better': 'higher', 'bound': 0.25,
                                'source': 'host_clock',
                                'workloads': ['dummy.small']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    out = run_cell(root, 'dummy.small')
    assert out['metrics']['calls_done']['value'] >= 1
    # infer_fps and movie_p90_ms list their cells: not this one
    assert set(out['metrics']) == {'setup_s', 'calls_done'}
    after = digests(root / 'portbench')
    assert {p: after[p] for p in before} == before


def test_a_new_architecture_runs_as_an_added_trunk_file(tmp_path):
    root = checkout(tmp_path)
    before = digests(root / 'portbench')

    bench = add_cell(root, 'alexnet_seeded', ALEXNET_CONFIG, 'alexnet_small',
                     'alexnet.small')
    for m in bench['end_to_end']:
        if m['name'] == 'infer_fps':
            m['workloads'].append('alexnet.small')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    trunk = root / 'portbench' / 'reference' / 'trunks' / 'alexnet.py'
    trunk.write_text(ALEXNET_TRUNK)
    flops = ('from types import SimpleNamespace\n'
             'from portbench.lib import config\n'
             'from portbench.reference import model as M\n'
             '_, _, conf, _ = harness.cell_of(".", "alexnet.small")\n'
             'P = config.params_json(SimpleNamespace(root=".", '
             'config=conf))\n'
             'out["arch"] = M.architecture(P)\n'
             'out["flops"] = M.forward_flops(P, harness.in_channels(P), '
             'P["TILESIZE"])\n')

    out = run_cell(root, 'alexnet.small', flops)
    assert out['correct'], out['checks']
    assert out['arch'] == 'alexnet' and out['flops'] > 0
    assert out['metrics']['infer_fps']['value'] > 0
    after = digests(root / 'portbench')
    assert {p: after[p] for p in before} == before

    trunk.write_text(ALEXNET_FAULT)
    out = run_cell(root, 'alexnet.small')
    assert not out['correct']
    gap = out['checks']['det_gap']
    assert gap['value'] > gap['limit']


def test_a_calibrated_configuration_runs_as_added_files(tmp_path):
    root = checkout(tmp_path)
    before = digests(root / 'portbench')

    bench = add_cell(root, 'resnet_calibrated', CALIBRATED_CONFIG,
                     'resnet_small', 'resnet.calibrated')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    out = run_cell(root, 'resnet.calibrated')
    assert out['correct'], out['checks']
    after = digests(root / 'portbench')
    assert {p: after[p] for p in before} == before

    trunk = root / 'portbench' / 'reference' / 'trunks' / 'resnet.py'
    source = trunk.read_text()
    assert source.count(RESNET_STEM) == 1
    trunk.write_text(source.replace(RESNET_STEM, RESNET_FAULT))
    out = run_cell(root, 'resnet.calibrated')
    assert not out['correct']
    gap = out['checks']['det_gap']
    assert gap['value'] > gap['limit']
