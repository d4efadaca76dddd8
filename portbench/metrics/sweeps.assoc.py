"""sweeps.assoc: the program's ``sweeps`` counter (each flush's final
sweep budget) over its ``flushes`` counter, summed over the window's
calls (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    records = spans.window_calls(rec)
    if not records:
        return None
    flushes = sum(r.counters.get('flushes', 0) for r in records)
    if not flushes:
        return None
    return sum(r.counters.get('sweeps', 0) for r in records) / flushes
