"""Tool entry points (each exposes ``main(args: dict)``)."""
