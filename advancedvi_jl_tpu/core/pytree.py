"""Pytree dataclass infrastructure.

The reference library threads mutable Julia structs through its protocol
(`src/AdvancedVI.jl:2-383`).  The equivalent is immutable pytree
dataclasses: every family, optimizer state, and algorithm state is a pytree so
it can flow through `jax.jit`, `jax.grad`, `lax.scan`, and `jax.sharding`
without any flatten/restructure machinery (the reference needs
`Optimisers.destructure` for this; here the pytree *is* the parameter vector).
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> dataclasses.Field:
    """Mark a dataclass field as static metadata (not traced by JAX)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Register a frozen dataclass as a JAX pytree.

    Fields declared with ``static_field()`` become hashable aux data (so they
    can select compiled code paths); all other fields are traced leaves.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    if not hasattr(cls, "replace"):
        cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls


def replace(obj: _T, **changes: Any) -> _T:
    """Functional update of a pytree dataclass."""
    return dataclasses.replace(obj, **changes)


def tree_stop_gradient(tree: _T) -> _T:
    """Detach every leaf of a pytree from the AD graph.

    Analogue of the reference's ``q_stop = restructure(params)``
    detached copy used for sticking-the-landing entropy
    (reference: src/algorithms/repgradelbo.jl:151-177).
    """
    return jax.lax.stop_gradient(tree)


def tree_zeros_like(tree: _T) -> _T:
    return jax.tree.map(jax.numpy.zeros_like, tree)


def tree_add(a: _T, b: _T) -> _T:
    return jax.tree.map(jax.numpy.add, a, b)


def tree_scale(a: _T, c) -> _T:
    return jax.tree.map(lambda x: c * x, a)


def tree_global_norm_sq(tree: Any):
    """Squared global L2 norm over all leaves.

    The reference flattens all variational parameters into one vector, so its
    parameter-free rules (DoG/DoWG) use the *global* norm
    (reference: src/optimization/rules.jl:17-64).  We reproduce that over the
    pytree without materializing a flat vector.
    """
    import jax.numpy as jnp

    leaves = jax.tree.leaves(tree)
    return sum(jnp.sum(jnp.square(x)) for x in leaves)
