"""Seconds from the process's start to the window's: imports, the
program's builds (its kernels and host libraries, in the first run of a
checkout only; their seconds are also printed apart as build_s), the
captures, the warm-up pass."""


def read(ctx):
    return ctx.setup_s
