"""call_ms: the whole window over the calls completed in it, host clock."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.calls if ctx.calls else None
