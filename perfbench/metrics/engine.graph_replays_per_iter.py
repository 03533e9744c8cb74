"""CUDA graph replays per engine iteration over the window
(``graph_replays`` / ``iterations``, the engine's counters read before and
after the window). None when the engine replays no graph."""


def read(ctx):
    w = ctx["window"]
    if not w["iterations"] or not w["graph_replays"]:
        return None
    return w["graph_replays"] / w["iterations"]
