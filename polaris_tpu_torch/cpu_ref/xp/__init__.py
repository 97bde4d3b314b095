"""The xp-generic formula modules of the JAX package that the NumPy oracle
(``cpu_ref/renderer.py``) runs with ``xp=np``, copied in the JAX package's
own layout (``ops/``, ``render/``) so that their relative imports resolve
inside this mirror and never to the port's torch modules.

Each file is its original byte for byte, with two exceptions: ``ops/rng.py``
lacks the three ``jnp_*`` functions, and ``ops/statics.py`` re-exports the
predicates of the port's JAX-free ``ops/statics.py``.
"""
