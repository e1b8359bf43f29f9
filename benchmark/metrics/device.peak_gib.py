"""The device memory peak of the traced assemble() call, in GiB:
`torch.cuda.max_memory_allocated()` after a reset before the call."""


def read(ctx):
    if not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
