"""setup_s: seconds from the process's start to the window's first call,
less a configuration's BatchNorm calibration (host clock)."""


def read(rec):
    return rec['setup_s']
