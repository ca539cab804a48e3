"""Host milliseconds a chunk spends in the Simulator shell and the live
view around the replay: the mission poll, the diagnostics sample, the
graph load and `LiveServer.push`, timed by the benchmark's spans over the
whole traced window (each span starts once the card has caught up, so a
wait for the replay is not counted)."""

SPANS = ("shell.poll", "shell.sample", "shell.load", "shell.push")


def read(out):
    chunks = out.stats.get("chunks")
    spans = out.stats.get("shell_spans")
    if not chunks or spans is None:
        return None
    return 1e3 * sum(spans.get(name, 0.0) for name in SPANS) / chunks
