"""StructDict: dict with attribute access, registered as a JAX pytree.

Functional replacement for the reference's core data structure (the
``michchr/structdict`` dependency, SURVEY.md §2a): every matrix bundle,
weight set, and parameter struct in this framework is carried in a
StructDict. Unlike the reference's, this one is a *pytree*, so whole
bundles flow through ``jit`` / ``vmap`` / ``grad`` / ``shard_map``
transparently — the device-native analogue of "attribute dict of numpy
matrices".

Keys are sorted for flattening so tree structure is deterministic and two
StructDicts with the same keys are always treedef-compatible.
"""

from __future__ import annotations

import jax


class StructDict(dict):
    """A dict whose items are also attributes, usable as a JAX pytree."""

    __slots__ = ()

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__!s} has no attribute or key {name!r}"
            ) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        items = ", ".join(f"{k}={_short(v)}" for k, v in sorted(self.items()))
        return f"{type(self).__name__}({items})"

    def copy(self):
        return type(self)(self)

    def update_new(self, *args, **kwargs):
        """Return a copy with the given updates applied (functional update)."""
        out = self.copy()
        out.update(*args, **kwargs)
        return out

    def sub_struct(self, keys):
        """Return a StructDict restricted to ``keys``."""
        return type(self)({k: self[k] for k in keys})


def _short(v):
    shape = getattr(v, "shape", None)
    if shape is not None:
        return f"{type(v).__name__}{tuple(shape)}"
    return repr(v)


def _sd_flatten(sd: StructDict):
    keys = sorted(sd.keys())
    return [sd[k] for k in keys], tuple(keys)


def _sd_flatten_with_keys(sd: StructDict):
    keys = sorted(sd.keys())
    return [(jax.tree_util.DictKey(k), sd[k]) for k in keys], tuple(keys)


def _sd_unflatten(keys, children):
    return StructDict(zip(keys, children))


jax.tree_util.register_pytree_with_keys(
    StructDict, _sd_flatten_with_keys, _sd_unflatten, _sd_flatten
)


def named_struct_dict(name: str, *field_names):
    """Create a named StructDict subclass (mirrors the reference API's
    ``named_struct_dict`` prototype pattern, SURVEY.md §2a).

    The subclass is registered as its own pytree node and remembers a
    default field order; constructing with positional args maps onto the
    declared fields.
    """
    fields = tuple(field_names)

    def __init__(self, *args, **kwargs):
        if args and len(args) > len(fields):
            raise TypeError(
                f"{name} takes at most {len(fields)} positional args"
            )
        dict.__init__(self, zip(fields, args))
        dict.update(self, kwargs)

    cls = type(name, (StructDict,), {"__init__": __init__, "_fields": fields,
                                     "__slots__": ()})

    def _flatten_with_keys(sd):
        keys = sorted(sd.keys())
        return [(jax.tree_util.DictKey(k), sd[k]) for k in keys], tuple(keys)

    def _flatten(sd):
        keys = sorted(sd.keys())
        return [sd[k] for k in keys], tuple(keys)

    def _unflatten(keys, children):
        out = cls.__new__(cls)
        dict.__init__(out, zip(keys, children))
        return out

    jax.tree_util.register_pytree_with_keys(
        cls, _flatten_with_keys, _unflatten, _flatten
    )
    return cls
