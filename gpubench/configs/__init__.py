"""Configurations: one JSON file each, and the generators they name."""
