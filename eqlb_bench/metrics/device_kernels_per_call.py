"""device_kernels_per_call: device kernels (copies and fills left out) a
call in the traced stretch."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.calls:
        return None
    n = st.kernels()
    return n / st.calls if n else None
