"""Reading a ``torch.profiler`` trace of a short span: the seconds in
which some operation ran on the device (the union of every kernel, copy
and fill, on every stream), the span's length, the device operations that
took most time and the longest idle gaps, each named by what the host was
doing meanwhile.

The span is the ``SPAN`` annotation the caller opens around the traced
work; the host labels are the innermost annotation (the harness's and the
program's wrapped stages, all named ``portbench.*``) and the innermost
operator that cover the middle of a gap.
"""
from collections import defaultdict

SPAN = 'portbench.span'
# characters of a kernel's name kept in the breakdown
NAME = 160


def _events(prof):
    return prof.profiler.kineto_results.events()


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, t):
    """Name of the shortest host event covering time t, or None."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def read(prof, top=10):
    """dict busy_s, window_s, device_ops [[name, s]], idle_gaps [[what,
    s]], or None when the trace holds no span or no device work."""
    span, device, host, notes = None, [], [], []
    for ev in _events(prof):
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if str(ev.device_type()) == 'DeviceType.CPU':
            if name == SPAN:
                span = (s, e)
            elif name.startswith('portbench.'):
                notes.append((s, e, name[len('portbench.'):]))
            else:
                host.append((s, e, name))
        elif not ev.is_user_annotation() and e > s:
            device.append((s, e, name))
    if span is None or not device:
        return None
    s0, s1 = span
    clipped = [(max(s, s0), min(e, s1), n) for s, e, n in device
               if e > s0 and s < s1]
    merged = _union([(s, e) for s, e, _ in clipped])
    busy = sum(e - s for s, e in merged)
    if busy <= 0:
        return None
    by_name = defaultdict(int)
    for s, e, n in clipped:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, t = [], s0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if s1 > t:
        gaps.append((t, s1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        what = ' / '.join(x for x in (_innermost(notes, mid),
                                      _innermost(host, mid)) if x)
        named.append([what or 'host', (b - a) / 1e9])
    return {'busy_s': busy / 1e9, 'window_s': (s1 - s0) / 1e9,
            'device_ops': [[n[:NAME], v / 1e9] for n, v in ops],
            'idle_gaps': named}


def label(obj, attr, name):
    """Wrap the method ``attr`` of ``obj`` in a ``record_function`` named
    ``portbench.<name>``; returns a function that undoes it."""
    from torch.profiler import record_function
    orig = getattr(obj, attr)

    def wrapped(*a, **k):
        with record_function(f'portbench.{name}'):
            return orig(*a, **k)
    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, orig)
