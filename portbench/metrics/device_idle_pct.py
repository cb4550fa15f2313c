"""Share of the traced window in which no kernel, memcpy or memset ran on
the card (the complement of the union of their CUPTI intervals)."""


def read(record):
    if record.window_s <= 0.0 or not record.device_ops:
        return None
    return 100.0 * (1.0 - record.busy_s / record.window_s)
