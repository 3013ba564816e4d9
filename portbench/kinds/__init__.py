"""Kinds of deployment, one module each, found by a configuration's
``kind``: ``kinds/<kind>.py`` makes the fields of the inputs from the seed
(``level_fields``) and holds them for the reference (``State``); it may
give its own ``hierarchy(cfg)`` and ``write_inputs``."""
