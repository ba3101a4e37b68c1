"""The share of the traced slice (%) in which no operation ran on the
device: 1 - (union of the device operations' intervals) / (slice)."""


def read(rec):
    sl = rec["slice"]
    if not sl.device_ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.seconds)
