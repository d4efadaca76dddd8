"""ided_ms: the program's ``IDed_dets`` spans a call (the identities'
array after the solve and the ``IDed_dets_all`` DataFrame on its first
read), mean over the window's calls, in ms (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    v = spans.per_call(rec, lambda r: spans.seconds(r, 'IDed_dets'))
    return None if v is None else 1e3 * v
