"""The card's idle share of the traced slice, in %: 1 - (union of the device
operations' intervals) / the slice's length."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["seconds"])
