"""The 95th percentile of the unprofiled stretch's emitting push and flush
calls, ms: from the call until its greedy tokens are on the host."""


def read(ctx):
    return ctx.get('stretch_p95_ms')
