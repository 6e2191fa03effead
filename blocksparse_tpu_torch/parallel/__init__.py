"""Distributed layer: block-row partitioning over a device mesh."""
