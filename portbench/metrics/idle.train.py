"""The share of the traced span (torch.profiler, a few steady calls or an
epoch boundary after the window) in which no operation ran on the
device, in %."""


def read(rec):
    tr = rec.get('trace')
    if not tr:
        return None
    return 100 * (1 - tr['busy_s'] / tr['window_s'])
