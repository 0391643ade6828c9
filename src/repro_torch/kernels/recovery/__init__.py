"""CATopt fitness: plain PyTorch version (``ref``), the CUDA kernel
(``kernel``) and the op boundary the GA calls (``ops``)."""
