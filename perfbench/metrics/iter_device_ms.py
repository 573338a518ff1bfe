"""Solvers and operators: device-busy ms of the work launched inside
``fit`` (the union of the device events that the fit spans launched), an
iteration."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["solves"]:
        return None
    ns = ctx["reader"].part_device_ns(tr, "fit")
    if ns <= 0:
        return None
    return ns * 1e-6 / (ctx["solves"] * ctx["iterations"])
