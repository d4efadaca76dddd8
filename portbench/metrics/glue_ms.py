"""glue_ms: the self time of the program's ``inference`` span a call (its
duration minus its child spans': the Python between the stages), mean
over the window's calls, in ms (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    v = spans.per_call(rec, lambda r: spans.self_seconds(r, 'inference'))
    return None if v is None else 1e3 * v
