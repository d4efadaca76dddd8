"""infer_fps: frames of every call completed in the window over the
window's wall seconds (host clock)."""


def read(rec):
    if 'calls' not in rec:
        return None
    return sum(c['frames'] for c in rec['calls']) / rec['window_s']
