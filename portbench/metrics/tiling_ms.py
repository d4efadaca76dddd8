"""tiling_ms: the program's ``tiling`` span (``Timelapse.construct_tiles``)
a call, mean over the window's calls, in ms (``lib/spans.py``)."""
from portbench.lib import spans


def read(rec):
    v = spans.per_call(rec, lambda r: spans.seconds(r, 'tiling'))
    return None if v is None else 1e3 * v
