"""Share of an untraced train step in which the card runs nothing while
the program has no stage open: `idle_pct.train` times the share of the
traced steps' idle seconds in which no `gs/` span of the program is open
on any host thread (`spans.py`). That idle belongs to the caller, the
benchmark's loop between steps, and no change inside the program can
remove it. The profiler's host cost stretches the traced idle seconds;
scaling the share by the untraced `idle_pct` leaves it out, as there."""

from splatbench import spans, work


def read(ctx):
    return spans.outside_idle_share(ctx["trace"]) * work.idle_pct(ctx)
