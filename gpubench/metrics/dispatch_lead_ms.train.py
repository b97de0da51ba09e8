"""record.lead_ms: host time from a dispatch's entry to its first step's
launch, the mean over the slice's dispatches."""

from gpubench.record import lead_ms


def read(ctx):
    return lead_ms(ctx)
