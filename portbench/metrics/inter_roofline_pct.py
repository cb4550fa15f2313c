"""``exact_tree_inter``'s share of its roofline: the least time of the
interaction sums the window's calls needed (``counts/trees.py``) over the
summed device time of the kernels its launches ran.  A launch of either
exact kernel runs its library's staging kernels (``pack_kernel``, and the
slot-table passes on wide inputs), its tile kernel and ``sum_tiles_kernel``
in order on one stream; the shared names are given to the tile kernel they
surround."""

from portbench.counts.roofline import least_seconds

TILES = {"inter_tile_kernel": "inter", "inter_slot_kernel": "inter",
         "phi_tile_kernel": "phi"}
STAGING = ("pack_kernel", "slot_hits_kernel", "slot_rank_kernel")


def launches(record):
    """``[(library, [ops])]`` of the exact kernels' launches, in order."""

    from portbench.trace import short_name

    out, pending = [], []
    for op in sorted((o for o in record.device_ops if o.kind == "kernel"),
                     key=lambda o: o.start):
        name = short_name(op.name)
        if name in STAGING:
            pending.append(op)
        elif name in TILES:
            out.append((TILES[name], pending + [op]))
            pending = []
        elif name == "sum_tiles_kernel" and out:
            out[-1][1].append(op)
    return out


def read(record):
    work = record.work.get("exact_tree_inter")
    spent = sum(record.seconds(ops) for lib, ops in launches(record) if lib == "inter")
    if work is None or spent <= 0.0:
        return None
    return 100.0 * least_seconds(work)[0] * record.calls / spent
