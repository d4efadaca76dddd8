"""Small sizes at which the harness runs on the CPU in the tests."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MOVIE = {'frames': 9, 'height': 1024, 'width': 2048, 'cones': 9,
         'start_span': 0.5, 'channels': 3, 'channel_height': 120,
         'movies': 1}
TRAIN = {'frames': 10, 'height': 1024, 'width': 936, 'cones': 16,
         'channels': 3, 'train_timepoints': [2, 3, 4, 5],
         'test_timepoints': [6, 7], 'batch_size': 4}


def run(workload, mix, seconds=0.3, seed=7, root=ROOT, control=False):
    """One harness run on the CPU (the card check skipped)."""
    from portbench.lib import harness
    return harness.run(root, workload, seed, seconds, 0, 'cpu',
                       time.perf_counter(), mix_over=mix,
                       log=lambda *a: None, control=control)
