"""k3_roofline: the least time the card could take for a call's K3
work (one saddle-point system per patch, counted from the reference's
patch sizes: roofline.solve_work "kkt") over K3's device time a call
(``lu_solve_bm*`` kernels in the traced stretch), in %."""

from eqlb_bench.roofline import bound


def read(ctx):
    st = ctx.stretch
    if st is None or not st.calls:
        return None
    t = st.device_s(lambda name: "lu_solve_bm" in name) / st.calls
    nbytes, flops = ctx.work["kkt"]
    if t <= 0 or not nbytes:
        return None
    return 100.0 * bound(nbytes, flops, ctx.dtype)[0] / (1e3 * t)
