"""Share of the profiled steps' span in which no device activity ran:
1 - (union of device intervals / span), on the trace's clock."""


def read(r):
    return 100.0 * r.trace.idle_share
