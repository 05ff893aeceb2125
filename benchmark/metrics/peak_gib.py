"""torch.cuda.max_memory_allocated() over set-up and window, in GiB."""


def read(ctx):
    b = ctx.get("peak_bytes")
    return None if b is None else b / 2**30
