"""A measurement run needs the card: without one it fails and prints no
result, and never falls back to the CPU."""
import subprocess
import sys

import pytest
import torch

from _small import ROOT


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'deployed.movie20', '--seed', '1', '--seconds', '1', '--trace',
         '0'], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA card' in proc.stderr


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    """Only BENCHMARK.json and portbench/: no program to measure."""
    import shutil
    shutil.copy(f'{ROOT}/BENCHMARK.json', tmp_path)
    shutil.copytree(f'{ROOT}/portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'deployed.movie20', '--seed', '1', '--seconds', '1', '--trace',
         '0'], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'deployed.movie20', '--seed', '3', '--seconds', '2', '--trace',
         '0'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and out['correct']
    assert out['device']['platform'] == 'gpu'
