"""The program's own trace records (``axtrack_tpu_torch.utils.profiling``:
``records()``, each with ``kind``, ``meta``, ``spans`` of [name, parent
index, start ns, duration ns] and ``counters``) of exactly the window's
calls or epochs, for the per-layer metrics that read spans and counters.

A call's record is the inference record whose ``detect``, ``association``
and ``mcf`` spans last exactly the seconds the call's ``timings`` hold
(the program takes those from the spans), so the warm-up rounds and the
traced calls drop out. The window's epochs are the records of epochs 1 to
``len(rec['epochs'])``, train and test: set-up runs epoch 0 and the traced
span follows the window. A program that keeps no records, or a window
call or epoch without its record, gives nothing.
"""
KEYS = ('detect', 'association', 'mcf')


def _log():
    try:
        from axtrack_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, 'records', None)
    return records() if records is not None else None


def seconds(record, name):
    """Seconds of the record's finished spans called ``name``, summed."""
    return sum(s[3] / 1e9 for s in record.spans
               if s[0] == name and s[3] is not None)


def self_seconds(record, name):
    """Seconds of the spans called ``name`` minus those of their direct
    child spans."""
    own = {i for i, s in enumerate(record.spans)
           if s[0] == name and s[3] is not None}
    inner = sum(s[3] for s in record.spans
                if s[1] in own and s[3] is not None)
    return (sum(record.spans[i][3] for i in own) - inner) / 1e9


def window_calls(rec):
    """The trace record of each window call, in order, or None."""
    calls, log = rec.get('calls'), _log()
    if not calls or log is None:
        return None
    by_key = {}
    for r in log:
        if getattr(r, 'kind', None) == 'inference':
            by_key[tuple(seconds(r, k) for k in KEYS)] = r
    out = []
    for c in calls:
        key = tuple(c['timings'].get(k) for k in KEYS)
        if None in key or key not in by_key:
            return None
        out.append(by_key[key])
    return out


def per_call(rec, value):
    """Mean of ``value(record)`` over the window's calls, or None."""
    records = window_calls(rec)
    if not records:
        return None
    return sum(value(r) for r in records) / len(records)


def window_epochs(rec):
    """[train record, test record] of each window epoch, or None."""
    n, log = len(rec.get('epochs') or []), _log()
    if not n or log is None:
        return None
    found = {}
    for r in log:
        e = getattr(r, 'meta', {}).get('epoch')
        if getattr(r, 'kind', None) == 'epoch' and e in range(1, n + 1):
            found.setdefault(e, {})[bool(r.meta.get('train'))] = r
    if any(len(found.get(e, {})) != 2 for e in range(1, n + 1)):
        return None
    return [[found[e][True], found[e][False]] for e in range(1, n + 1)]


def per_epoch(rec, value):
    """Mean over the window's epochs of ``value(record)`` summed over the
    epoch's train and test records, or None."""
    epochs = window_epochs(rec)
    if not epochs:
        return None
    return sum(value(a) + value(b) for a, b in epochs) / len(epochs)
