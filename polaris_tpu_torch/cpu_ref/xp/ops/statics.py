"""The scene-static predicates the formula modules of the oracle read.

The JAX package's ``ops/statics.py`` registers ``Static`` as a JAX pytree,
so it is not copied here. The five predicates are byte for byte the JAX
ones in the port's own ``ops/statics.py``, which imports NumPy only.
"""

from ....ops.statics import bg_has_tex, has_bxdf, has_light, has_op, tex_on

__all__ = ["bg_has_tex", "has_bxdf", "has_light", "has_op", "tex_on"]
