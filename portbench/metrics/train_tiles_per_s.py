"""train_tiles_per_s: tiles stepped in the window's epochs (train and
test) over the window's wall seconds (host clock)."""


def read(rec):
    if 'epochs' not in rec:
        return None
    return sum(e['train_tiles'] + e['test_tiles']
               for e in rec['epochs']) / rec['window_s']
