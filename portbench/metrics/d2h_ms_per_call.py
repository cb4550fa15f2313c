"""Device-to-host copy time per call: the summed CUPTI ``Memcpy DtoH``
records in the traced window over the calls."""


def read(record):
    copies = [o for o in record.device_ops if o.kind == "memcpy" and "DtoH" in o.name]
    if not copies or record.calls == 0:
        return None
    return 1e3 * record.seconds(copies) / record.calls
