"""Numerical linear algebra (counterpart of ``pyxu_tpu/math``)."""
