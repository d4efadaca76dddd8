"""The frozen metric arithmetic: the FLOP count, K1's work count, and the
trace reader's busy time, idle gaps and breakdown."""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _small import ROOT
from portbench.lib import k1work, peaks, trace
from portbench.reference import geodesic as G
from portbench.reference import model as M


def params():
    with open(f'{ROOT}/deployed_model/params.json') as f:
        return json.load(f)


@pytest.mark.parametrize('arch, gflop', [(None, 125.9), ('resnet', 933.1)])
def test_batch16_train_step_flops(arch, gflop):
    P = params()
    if arch:
        P['ARCHITECTURE'] = arch
    step = 3 * 16 * M.forward_flops(P, 5, 512)
    assert round(step / 1e9, 1) == gflop


@pytest.mark.parametrize('arch, flops', [(None, 2_623_111_168),
                                         ('resnet', 19_440_539_264)])
def test_forward_flops_of_a_512_px_tile(arch, flops):
    P = params()
    if arch:
        P['ARCHITECTURE'] = arch
    assert M.forward_flops(P, 5, 512) == flops


def test_a_depthwise_convolution_counts_its_per_group_fan_in():
    N, C, H, W = 2, 8, 6, 5
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, C, H, W, generator=g)
    w = torch.randn(C, 1, 3, 3, generator=g)
    ops = M.Ops(count=True)
    y = ops.conv(x, w, None, 1, 1, groups=C)
    # each channel with its own 3x3 filter: N.C.H.W.9, not N.C.H.W.C.9
    assert ops.macs == N * C * H * W * 9
    one = [F.conv2d(x[:, c:c + 1], w[c:c + 1], None, 1, 1) for c in range(C)]
    torch.testing.assert_close(y, torch.cat(one, 1))


def test_an_architecture_without_a_trunk_file_is_refused():
    P = params()
    P['ARCHITECTURE'] = 'nosuchnet'
    with pytest.raises(ValueError, match=r'trunks/nosuchnet\.py'):
        M.forward_flops(P, 5, 512)


def test_k1_work_on_a_hand_worked_mask():
    # a 2-row channel across a 8 x 24 mask; one source at (2, 5) in frame
    # 0, one target at (3, 10) in frame 1: 1 + 5 steps, 7 nodes
    mask = np.zeros((8, 24), bool)
    mask[2:4] = True
    dets = [{'anchor_y': np.array([2]), 'anchor_x': np.array([5])},
            {'anchor_y': np.array([3]), 'anchor_x': np.array([10])}]
    dists, work = G.lookback(mask, dets, 2, 0.7, 'cpu')
    assert dists[(1, 1)].tolist() == [[7.0]]
    assert work == {'reached': 48, 'window': 24, 'sources': 1, 'n_dets': 2,
                    'n_pairs': 1}
    seconds, bound = k1work.least(work)
    # 24 x 24 mask bits + 2 detections x 8 bytes + 1 distance x 4 bytes
    assert bound == 'bytes'
    assert seconds == pytest.approx((72 + 16 + 4) / peaks.HBM_BYTES_PER_S)
    assert 5 * 48 / peaks.F32_FLOPS < seconds


class _Ev:
    def __init__(self, name, s, e, dev='DeviceType.CPU', note=False):
        self._n, self._s, self._e, self._d, self._u = name, s, e, dev, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._u


class _Prof:
    def __init__(self, events):
        class R:
            def events(_):
                return events

        class P:
            kineto_results = R()
        self.profiler = P()


def test_trace_reader_busy_gaps_and_breakdown():
    cuda = 'DeviceType.CUDA'
    ev = [_Ev(trace.SPAN, 0, 1000),
          _Ev('portbench.mcf', 600, 900),
          _Ev('aten::copy_', 700, 760),
          _Ev('conv', 100, 300, cuda), _Ev('conv', 250, 400, cuda),
          _Ev('bn', 450, 500, cuda), _Ev(trace.SPAN, 100, 1000, cuda,
                                         note=True),
          _Ev('late', 950, 1200, cuda)]
    got = trace.read(_Prof(ev))
    # device busy [100, 400] + [450, 500] + [950, 1000] = 400 ns
    assert got['busy_s'] == pytest.approx(400e-9)
    assert got['window_s'] == pytest.approx(1000e-9)
    assert got['device_ops'][0] == ['conv', pytest.approx(350e-9)]
    gaps = got['idle_gaps']
    assert gaps[0] == ['mcf / aten::copy_', pytest.approx(450e-9)]
    assert [g[1] for g in gaps] == pytest.approx([450e-9, 100e-9, 50e-9])


def test_trace_reader_without_device_work_reads_nothing():
    assert trace.read(_Prof([_Ev(trace.SPAN, 0, 10)])) is None
