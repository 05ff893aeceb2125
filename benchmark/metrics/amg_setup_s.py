"""Layer: host set-up.  Host clock around the port's AMG set-up and
amg_from_numpy, caches off (s).  Moves setup_s."""


def read(ctx):
    return ctx["spans"].get("amg_setup_s")
