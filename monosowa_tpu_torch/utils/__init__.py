"""Logging, seeding and per-stage timing helpers (the JAX package's
``utils/``; its ``jaxcache.py`` has no counterpart: the port's compiled
kernels are cached by ``ops/_build.py``'s build directory)."""
