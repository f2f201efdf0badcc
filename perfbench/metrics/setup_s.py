"""Seconds from the process's start to the window's start: the kernel
library's load (its build in a fresh checkout), the data, the model's
training and the warm-up of every size."""


def read(ctx):
    return ctx.setup_s
