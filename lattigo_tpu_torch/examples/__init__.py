"""Runnable demo programs: the port's counterparts of ``examples/``.

Each script keeps its JAX twin's file name, parameters and asserts, and
``main(**kwargs)`` takes ``device`` as well (none: the card, or raises).
"""
