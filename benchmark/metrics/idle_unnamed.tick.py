"""Share of the traced live chunks' device-idle time that no leaf span of
the program names, in %: idle time in which the innermost open span is
none or a container (`sim.advance`, `sim.run`, `sim.chunk`)."""

from benchmark.program_spans import idle_unnamed_share


def read(out):
    return idle_unnamed_share(out)
