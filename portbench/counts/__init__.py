"""Work counts and peaks: the least time the card could take for a piece
of work, from the model and the inputs, whatever implements it.

Each count reads every input byte once and writes every output byte once,
and puts each operation on the fastest unit that keeps the configuration's
float32 accuracy (``roofline.least_seconds``).  Where a count is unsure it
takes the smaller number, so a share of it never reads above 100% for an
honest program.
"""
