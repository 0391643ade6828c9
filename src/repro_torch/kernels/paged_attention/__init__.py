"""Paged-KV attention: plain PyTorch version (``ref``), the CUDA kernel
(``kernel``) and the op boundary the serving step calls (``ops``)."""
