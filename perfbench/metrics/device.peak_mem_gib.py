"""Peak device memory the run allocated, in GiB
(``torch.cuda.max_memory_allocated`` after the window)."""


def read(ctx):
    b = ctx["memory"]["max_allocated"]
    return b / 2**30 if b else None
