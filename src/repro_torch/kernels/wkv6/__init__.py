"""The RWKV-6 recurrence: plain PyTorch version (``ref``), the CUDA kernel
(``kernel``) and the op boundary the model calls (``ops``)."""
