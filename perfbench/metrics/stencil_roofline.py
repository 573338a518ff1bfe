"""Kernels: the stencil kernel's share of its roofline, the least time of
the separable correlations the window's generic iterations need
(``work/stencil``) over the device time of the kernels named
``st_kernel``."""


def read(ctx):
    return ctx["roofline"]("stencil", lambda n: "st_kernel<" in n,
                           ctx["iterations"])
