"""Fault tolerance: the straggler policy the sweep engine uses."""
