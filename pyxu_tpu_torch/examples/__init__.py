"""Example programs: the JAX package's ``examples/`` against the port.

Each module runs as ``python -m pyxu_tpu_torch.examples.<name>`` and has
the JAX program's ``main(...)`` signature, defaults and printout, plus
``device``: the card unless the caller passes ``device="cpu"``.
``tv_deconvolution.ipynb`` is the notebook's walkthrough over the port.
"""
