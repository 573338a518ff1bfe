"""Kernels: the fused TV step's share of its roofline, the least time of
the window's Condat-Vu iterations (``work/tv_step``) over the device time
of the kernels named ``tv_step_kernel``."""


def read(ctx):
    return ctx["roofline"]("tv_step", lambda n: "tv_step_kernel<" in n,
                           ctx["iterations"])
