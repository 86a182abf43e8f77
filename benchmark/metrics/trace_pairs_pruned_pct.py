"""``trace_pairs_pruned_pct``: the share of the (ray, triangle) pairs of the
boxes its rays enter that the port's trace kernels prune by distance in a
traced frame, 100 x pruned / (run + pruned) (``FrameRecord.pair_tests``,
summed over the depths and bands), mean over the traced frames: how far
the near-first, distance-pruned closest hit engages. Layer: kernels. Moves
``frame_ms``. Nothing where the program keeps no such counter: frame
records without ``pair_tests``, or with none filled."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    shares = []
    for _, rec in program.frames(trace):
        pairs = getattr(rec, "pair_tests", None)
        if not pairs:
            continue
        run = sum(r for r, _ in pairs.values())
        pruned = sum(p for _, p in pairs.values())
        if run + pruned > 0:
            shares.append(100.0 * pruned / (run + pruned))
    if not shares:
        return None
    return sum(shares) / len(shares)
