"""k1_roofline: the least time the card could take for a call's K1
work (the semi-explicit mode's boundary-patch solves over the
divergence-free flux space, counted from the reference's patch sizes:
roofline.solve_work "reduced") over K1's device time a call
(``lu_solve_bl*`` kernels in the traced stretch), in %."""

from eqlb_bench.roofline import bound


def read(ctx):
    st = ctx.stretch
    if st is None or not st.calls:
        return None
    t = st.device_s(lambda name: "lu_solve_bl" in name) / st.calls
    nbytes, flops = ctx.work["reduced"]
    if t <= 0 or not nbytes:
        return None
    return 100.0 * bound(nbytes, flops, ctx.dtype)[0] / (1e3 * t)
