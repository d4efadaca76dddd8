"""Port parity: parameters, and the port's import isolation.

The port (axtrack_tpu_torch) must read the deployed bundle's params.json to
exactly the dict the JAX package reads, and must import with JAX, the JAX
package, pandas and PIL all unavailable (the GPU machine has none of them).
"""
import os
import subprocess
import sys

import torch

from axtrack_tpu.params import load_parameters as jax_load_parameters
from axtrack_tpu_torch.params import load_parameters, _from_jsonable
from axtrack_tpu_torch import config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, 'deployed_model')


def test_params_equal_jax_key_for_key():
    want = jax_load_parameters(None, None, from_directory=BUNDLE)
    got = load_parameters(None, None, from_directory=BUNDLE)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key


def test_json_codec_tuples_and_ranges():
    enc = {'a': {'__tuple__': [1, {'__tuple__': [2, 3]}]},
           'r': {'__range__': [2, 10, 2]}, 'l': [{'__tuple__': ['x']}]}
    assert _from_jsonable(enc) == {'a': (1, (2, 3)), 'r': range(2, 10, 2),
                                   'l': [('x',)]}


def test_device_policy():
    assert config.resolve_device('cpu') == torch.device('cpu')
    if not torch.cuda.is_available():
        for dev in (None, 'auto', 'cuda'):
            try:
                config.resolve_device(dev)
            except RuntimeError as e:
                assert "device='cpu'" in str(e)
            else:
                raise AssertionError(f'{dev!r} resolved without a GPU')


def test_import_isolation():
    code = (
        "import sys\n"
        "for m in ('jax', 'axtrack_tpu', 'pandas', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import axtrack_tpu_torch, axtrack_tpu_torch.interface\n"
        "import axtrack_tpu_torch.ops.geodesic_cuda\n"
        "import chip_smoke\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pandas', 'PIL') "
        "or m.startswith('axtrack_tpu.') or m == 'axtrack_tpu')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'isolated' in out.stdout


def test_smoke_script_ends_the_processes_it_starts(tmp_path):
    """A spawned worker pool leaves the multiprocessing resource tracker
    running after it closes; chip_smoke's stop_children must end it (and
    any other child) and wait for it."""
    script = tmp_path / 'pool.py'
    script.write_text(
        "import multiprocessing as mp\n"
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke\n"
        "def sq(x):\n"
        "    return x * x\n"
        "def search():\n"
        "    with mp.get_context('spawn').Pool(2) as pool:\n"
        "        return pool.map(sq, range(4))\n"
        "if __name__ == '__main__':\n"
        "    assert search() == [0, 1, 4, 9]\n"
        "    before = chip_smoke.child_pids()\n"
        "    ended = chip_smoke.stop_children()\n"
        "    print(len(before), ended, chip_smoke.child_pids())\n")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_before, rest = out.stdout.split(' ', 1)
    assert int(n_before) == 1, out.stdout           # the tracker alone
    assert 'resource tracker' in rest and rest.strip().endswith('[]'), rest
    assert 'Error' not in out.stderr, out.stderr


def test_no_jax_in_sources():
    pkg = os.path.join(REPO, 'axtrack_tpu_torch')
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    for f in files:
        with open(f) as fh:
            for line in fh:
                s = line.strip()
                assert not s.startswith(('import jax', 'from jax')), (f, s)
                assert not s.startswith(('import axtrack_tpu ',
                                         'from axtrack_tpu ',
                                         'from axtrack_tpu.',
                                         'import axtrack_tpu.')), (f, s)
