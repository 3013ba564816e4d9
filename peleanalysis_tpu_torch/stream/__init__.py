"""Streamline tracing: the RK4 march kernel, seed assignment, sampling and
the per-line surface decorators."""
