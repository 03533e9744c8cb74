"""Decode rows per engine iteration over the window: the tokens the decode
steps delivered (first tokens come from prefill and are left out) over
``step()`` calls, as the benchmark observed them between steps."""


def read(ctx):
    w = ctx["window"]
    if not w["iterations"]:
        return None
    return w["decode_rows"] / w["iterations"]
