"""movie_p90_ms: the 90th percentile (linear interpolation) of the
calls' wall times in the window, in ms (host clock)."""
import numpy as np


def read(rec):
    if not rec.get('calls'):
        return None
    return float(np.percentile([c['seconds'] for c in rec['calls']], 90)
                 * 1e3)
