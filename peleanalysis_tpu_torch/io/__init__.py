"""Plotfile and FAB I/O (numpy, host side)."""
