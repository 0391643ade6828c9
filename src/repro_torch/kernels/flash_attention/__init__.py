"""Flash attention for training: plain PyTorch version (``ref``), the CUDA
kernels (``kernel``) and the op boundary the model calls (``ops``)."""
