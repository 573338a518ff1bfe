"""The separable correlations that one generic Condat-Vu TV iteration
needs at the frame size, counted from the problem, float32: the blur K x
and its adjoint K^T r (an image in, an image out, 2 axes of ``blur_taps``
taps, a multiply and an add a tap), the gradient D x (an image in, two
out, a subtraction an output) and its adjoint D^T z (two in, one out, a
subtraction an input)."""


def work(cfg: dict, traffic: dict) -> dict:
    H, W = cfg["frame"]
    k = int(cfg["blur_taps"])
    px = H * W
    images = 2 + 2 + 3 + 3
    flops = 2 * (2 * 2 * k * px) + 2 * px + 2 * px
    return dict(bytes=4 * images * px, flops=flops)
