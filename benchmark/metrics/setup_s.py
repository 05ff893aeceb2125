"""Set-up: process start to the first measured load case (seconds)."""


def read(ctx):
    return ctx["setup_s"]
