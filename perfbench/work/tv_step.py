"""One Condat-Vu TV iteration at the frame size (the fused ``tv_step``'s
work), counted from the problem: x, z (2 per pixel) and y read once, x
and z written once, float32; per pixel the blur and its adjoint (2 axes
each, a multiply and an add a tap), K x - y, the gradient and its adjoint
(a subtraction each per partial), the x update, 2 x+ - x, the z update
and its projection on the lam-ball (squares, a sum, a square root, a
division, a minimum, two products)."""


def work(cfg: dict, traffic: dict) -> dict:
    H, W = cfg["frame"]
    k = int(cfg["blur_taps"])
    px = H * W
    flops_px = 2 * (2 * 2 * k) + 1 + 2 + 2 + 4 + 2 + 4 + 9
    return dict(bytes=4 * 7 * px, flops=flops_px * px)
