"""Host milliseconds a chunk in the Simulator's `advance`, less its wait
for the card: the program's `sim.advance` spans inside the traced window,
less the `sim.wait` spans inside them, over the traced chunks (one
`advance` a chunk)."""

from benchmark.program_spans import span_ns, window_spans


def read(out):
    found = window_spans(out)
    if found is None:
        return None
    _, spans = found
    chunks = sum(1 for name, _, _ in spans if name == "sim.advance")
    if not chunks:
        return None
    return (span_ns(spans, "sim.advance") - span_ns(spans, "sim.wait")) / 1e6 / chunks
