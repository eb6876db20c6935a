"""stages_device_ms: device time a call of every device operation that is
not one of the port's own kernels (K1 / K3 ``lu_solve_b*``, K2 / K4
``*combine_gather_kernel``) nor an upload from the host (``Memcpy HtoD``,
the engine's per-call input copy of the boundary data): the semi-explicit
stages or the KKT assembly, with their device copies and fills, from the
traced stretch."""

PORT_KERNELS = ("lu_solve_b", "combine_gather_kernel")
UPLOADS = "Memcpy HtoD"


def read(ctx):
    st = ctx.stretch
    if st is None or not st.calls:
        return None
    t = st.device_s(lambda name: not (any(p in name for p in PORT_KERNELS)
                                      or name.startswith(UPLOADS)))
    return 1e3 * t / st.calls if t > 0 else None
