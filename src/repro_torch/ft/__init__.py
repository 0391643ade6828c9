"""Fault tolerance: the straggler policy the sweep engine uses, and the
preemptible, checkpointing train loop."""
