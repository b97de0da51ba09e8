"""readers.idle_pct, for the train mix."""

from gpubench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
