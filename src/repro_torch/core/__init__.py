"""P2RAC core in PyTorch: the platform (5-verb API), resources, registry,
project sync, the sweep engine and the CATopt GA (the counterpart of
``repro.core``)."""
