"""Graph primitives on the dense-block layout and the Laguerre kernels."""
