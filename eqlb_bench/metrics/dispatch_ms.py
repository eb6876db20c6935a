"""dispatch_ms: host clock from the call into EqlbEngine.equilibrate to its
return, no sync, mean over the window's calls outside the traced stretch."""


def read(ctx):
    d = ctx.dispatch_s
    return 1e3 * sum(d) / len(d) if d else None
