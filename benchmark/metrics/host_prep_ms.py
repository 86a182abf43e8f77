"""``host_prep_ms``: the host's work on a frame before its graph is
launched: from the start of the port's ``cosig.frame`` span to the start
of its first ``cosig.frame.launch`` (the settings, the uniforms, the
cache lookups, the frame buffer's write), mean over the traced frames
(program spans on torch.profiler's clock). Layer: frame host path. Moves
``frame_ms``; ``host_prep_ms.preview`` moves ``frame_ms.preview``.
Nothing where the program has no such spans."""

import bisect

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    launches = [s for s, _ in program.spans(trace, "cosig.frame.launch")]
    preps = []
    for s, e in program.spans(trace, "cosig.frame"):
        i = bisect.bisect_left(launches, s)
        if i < len(launches) and launches[i] < e:
            preps.append(launches[i] - s)
    if not preps:
        return None
    return sum(preps) / len(preps) / 1e3
