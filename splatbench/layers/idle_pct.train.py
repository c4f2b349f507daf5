"""Share of an untraced train step in which no operation runs on the card:
1 - (the traced steps' device busy seconds per step) / (the window's
seconds per step, `train_step_ms`). The profiler slows the host, so its
own window would count that cost as idle; the busy seconds it reads are
the card's."""

from splatbench import work


def read(ctx):
    return work.idle_pct(ctx)
