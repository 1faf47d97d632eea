"""Scene construction: builder nodes, flattening, generators."""
from . import nodes, flatten
from .nodes import *  # noqa: F401,F403
from .flatten import FlatScene, Plan, flatten, from_jax_arrays  # noqa: F401
