"""Stage timers and device traces (counterpart of
``axtrack_tpu/utils/profiling.py``).

``StageTimer`` accumulates named host-clock stages; a stage given a result
waits for the device first, so its time covers the device work.
``device_trace`` records a ``torch.profiler`` trace of the CPU and, where
there is a card, the CUDA activities, written as a Chrome trace.
"""
import contextlib
import json
import os
import time

import torch


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _tensors(v)


class StageTimer:
    """Accumulating named stage timer.

    with timer.stage('detect', sync_result=out):
        out = ...
    timer.summary() -> {'detect': {'total_s': ..., 'calls': ...}, ...}
    """

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                self.sync(sync_result)
            rec = self.stages.setdefault(name, {'total_s': 0.0, 'calls': 0})
            rec['total_s'] += time.perf_counter() - t0
            rec['calls'] += 1

    @staticmethod
    def sync(result):
        """Wait until the work that makes ``result`` (a tensor, or a tuple,
        list or dict holding tensors) is done: ``torch.cuda.synchronize``
        on each card its CUDA tensors lie on."""
        for dev in {t.device for t in _tensors(result)
                    if t.device.type == 'cuda'}:
            torch.cuda.synchronize(dev)

    def summary(self):
        return {k: dict(v) for k, v in self.stages.items()}

    def report(self):
        return '\n'.join(
            f"{name:24} {rec['total_s']:8.3f}s ({rec['calls']} calls)"
            for name, rec in sorted(self.stages.items(),
                                    key=lambda kv: -kv[1]['total_s']))

    def dump(self, fname):
        with open(fname, 'w') as f:
            json.dump(self.summary(), f, indent=1)


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones when a card is present) and write the Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums the time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
