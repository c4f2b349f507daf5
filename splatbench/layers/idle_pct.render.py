"""Share of an untraced render frame in which no operation runs on the
card: 1 - (the traced frames' device busy seconds per frame) / (the
window's seconds per frame, 1 / `render_fps`). The profiler slows the
host, so its own window would count that cost as idle; the busy seconds
it reads are the card's."""

from splatbench import work


def read(ctx):
    return work.idle_pct(ctx)
