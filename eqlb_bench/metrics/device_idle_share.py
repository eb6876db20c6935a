"""device_idle_share: the share of the traced stretch (host clock) in which
no operation ran on the device, in %."""


def read(ctx):
    st = ctx.stretch
    if st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
