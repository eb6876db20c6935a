"""geometry_caches_s: host clock around the engine's set-up on the card
(the boundary data's upload, _device_tables with K1's interior inverses,
or _kkt_tables), ending in a sync."""


def read(ctx):
    return ctx.geometry_caches_s
