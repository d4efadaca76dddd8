"""No module a run loads, nor the reference, is JAX's or the JAX
package's; names are compared whole (the port's name begins with the
JAX package's)."""
import os
import subprocess
import sys

from _small import ROOT
from portbench.lib import harness

TRUNKS = os.path.join(ROOT, 'portbench', 'reference', 'trunks')


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'axtrack_tpu_torch_x', object())
    monkeypatch.setitem(sys.modules, 'jaxlibx', object())
    assert 'axtrack_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'axtrack_tpu.ops', object())
    monkeypatch.setitem(sys.modules, 'flax.linen', object())
    assert set(harness.forbidden_modules()) >= {'axtrack_tpu', 'flax'}


def _loaded_after(code):
    proc = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(sorted({m.split(".")[0] for m in sys.modules}))'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_loads_nothing_of_jax():
    top = _loaded_after(
        'import sys; sys.path.insert(0, "portbench/tests")\n'
        'import _small\n'
        '_small.run("deployed.movie20", _small.MOVIE, seconds=0.1)')
    assert not top & set(harness.FORBIDDEN)
    assert 'axtrack_tpu_torch' in top


def test_the_reference_imports_nothing_of_the_program():
    trunks = sorted(f[:-3] for f in os.listdir(TRUNKS)
                    if f.endswith('.py') and f != '__init__.py')
    assert {'spec', 'resnet'} <= set(trunks)
    top = _loaded_after(
        'import sys, importlib; sys.path.insert(0, ".")\n'
        'from portbench.reference import calibrate, detect, geodesic, '
        'mcf, model, orbax, train\n'
        f'for name in {trunks!r}:\n'
        '    importlib.import_module("portbench.reference.trunks." + name)')
    assert not top & (set(harness.FORBIDDEN) | {'axtrack_tpu_torch'})
