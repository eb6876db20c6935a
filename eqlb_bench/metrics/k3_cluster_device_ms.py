"""k3_cluster_device_ms: device time a call of K3's cluster route (the
``lu_solve_bm_cluster*`` kernels in the traced stretch), in ms; nothing
where no such kernel ran."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.calls:
        return None
    t = st.device_s(lambda name: "lu_solve_bm_cluster" in name)
    return 1e3 * t / st.calls if t > 0 else None
