"""Seconds of the first assemble() call in the process, after the port's
kernels and native library are built: what a user who runs one genome a
process pays for lazy imports, library loads and the allocator's first
growth.  Part of set-up, so it moves `setup_s`.  By the host's clock,
ended by a CUDA synchronisation."""


def read(ctx):
    return ctx["cold_s"]
