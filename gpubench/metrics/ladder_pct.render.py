"""record.ladder_pct: the share of the traced image's time in the budget
ladder's raised rungs, and in renders whose rows were dropped."""

from gpubench.record import ladder_pct


def read(ctx):
    return ladder_pct(ctx)
