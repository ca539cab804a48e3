"""Share of the traced sweep row spent in the eager warm-up chunk of its
graph captures, in %: the program's `graph.warmup` spans
(graph/chunk.py:TickGraph) inside the traced window over the window."""

from benchmark.program_spans import span_ns, window_spans


def read(out):
    found = window_spans(out)
    if found is None:
        return None
    trace, spans = found
    return 100.0 * span_ns(spans, "graph.warmup") / (trace.end_ns - trace.start_ns)
