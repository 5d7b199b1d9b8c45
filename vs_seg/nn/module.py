"""A small module system: dataclass modules with named variable scopes.

Keeps the call surface the rest of the package (and the reference-checkpoint
converter) is written against:

    variables = model.init(rngs, x, train=False)
        -> {"params": {...}, "batch_stats": {...}}
    out = model.apply(variables, x, train=False)
    out, mutated = model.apply(variables, x, train=True,
                               mutable=["batch_stats"], rngs={"dropout": k})

A module is a dataclass whose `__call__` creates its submodules inline and
calls them. A submodule called inside a parent's `__call__` gets the scope
`parent_path + (name,)`; its `param` / `variable` entries live at that path
in the nested variable dicts, so key paths are e.g.
`params/down_0/unit0/conv/kernel`. Unnamed submodules are named
`<ClassName>_<n>` in call order. Each call runs under `jax.named_scope` of
its name, so compiled ops carry the module path (e.g. `down_0/unit0/conv`)
that profiler traces are attributed by.

Randomness is derived from the path: a parameter's init key is
`fold_in(rngs["params"], hash(path))`, and the k-th `make_rng(name)` call of
a module is `fold_in(fold_in(rngs[name], hash(path)), k)`. A module class
made by `remat(cls)` runs its `__call__` under `jax.checkpoint` with the same
keys, so rematerialisation changes memory use, not results.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Scopes of the module calls in progress, innermost last.
_STACK: list = []


def _path_hash(path: Tuple[str, ...]) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


def _copy_dicts(tree):
    """Copy the dict structure of a variable tree (arrays are shared)."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Frame:
    """State of one init/apply call: the variables, rngs and mutability."""

    def __init__(self, variables, rngs, mutable, initializing,
                 prefix: Tuple[str, ...] = ()):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.prefix = prefix  # absolute path of this frame's root (remat)
        self.rng_counts: Dict[Tuple, int] = {}

    def is_mutable(self, col: str) -> bool:
        if self.initializing or self.mutable is True:
            return True
        if not self.mutable:
            return False
        if isinstance(self.mutable, str):
            return col == self.mutable
        return col in self.mutable


class _Scope:
    def __init__(self, frame: _Frame, path: Tuple[str, ...]):
        self.frame = frame
        self.path = path
        self.children: Dict[str, Any] = {}
        self.auto_counts: Dict[str, int] = {}

    def collection(self, col: str, create: bool) -> Optional[dict]:
        d = self.frame.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.frame.variables[col] = {}
        for p in self.path:
            nxt = d.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = d[p] = {}
            d = nxt
        return d

    def child(self, module: "Module") -> "_Scope":
        name = module.name
        if name is None:
            cls = type(module).__name__
            n = self.auto_counts.get(cls, 0)
            self.auto_counts[cls] = n + 1
            name = f"{cls}_{n}"
        if name in self.children:
            raise ValueError(
                f"two submodules named {name!r} under "
                f"{'/'.join(self.path) or '<root>'}")
        self.children[name] = module
        return _Scope(self.frame, self.path + (name,))

    def key_path(self, *names) -> Tuple[str, ...]:
        return self.frame.prefix + self.path + names


class _Variable:
    """A named entry of a non-parameter collection (e.g. batch_stats)."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.collection(self._col, create=False)[self._name]

    @value.setter
    def value(self, v):
        if not self._scope.frame.is_mutable(self._col):
            raise ValueError(
                f"collection {self._col!r} is immutable; pass "
                f"mutable=[{self._col!r}] to apply")
        self._scope.collection(self._col, create=True)[self._name] = v


def _is_traced_arg(a) -> bool:
    """Arguments passed through jax.checkpoint (arrays, pairs of arrays);
    everything else (flags, None) is closed over as a static value."""
    return isinstance(a, (jax.Array, np.ndarray, tuple, list))


def _wrap_call(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self._scope is None:
            if not _STACK:
                raise RuntimeError(
                    f"{type(self).__name__} must be run through init/apply "
                    "or called inside another module")
            self._scope = _STACK[-1].child(self)
        scope = self._scope
        if getattr(type(self), "_remat", False) and not scope.frame.initializing:
            return _remat_call(self, fn, args, kwargs)
        _STACK.append(scope)
        try:
            with jax.named_scope(scope.path[-1] if scope.path else
                                 type(self).__name__):
                return fn(self, *args, **kwargs)
        finally:
            _STACK.pop()

    return call


def _remat_call(module: "Module", fn: Callable, args, kwargs):
    """Run `fn` under jax.checkpoint with the module's variables and rngs as
    explicit inputs, and write the mutated collections back afterwards."""
    scope = module._scope
    frame = scope.frame
    sub = {}
    for col in frame.variables:
        d = scope.collection(col, create=False)
        if d is not None:
            sub[col] = d
    traced = [a for a in args if _is_traced_arg(a)]

    def inner(sub_vars, rngs, traced_args):
        it = iter(traced_args)
        full = [next(it) if _is_traced_arg(a) else a for a in args]
        inner_frame = _Frame(_copy_dicts(sub_vars), rngs, frame.mutable,
                             False, prefix=frame.prefix + scope.path)
        m = copy.copy(module)
        m._scope = _Scope(inner_frame, ())
        _STACK.append(m._scope)
        try:
            out = fn(m, *full, **kwargs)
        finally:
            _STACK.pop()
        mutated = {c: inner_frame.variables[c] for c in inner_frame.variables
                   if frame.is_mutable(c)}
        return out, mutated

    with jax.named_scope(scope.path[-1]):
        out, mutated = jax.checkpoint(inner)(sub, dict(frame.rngs), traced)
    for col, tree in mutated.items():
        d = scope.collection(col, create=True)
        d.clear()
        d.update(tree)
    return out


class Module:
    """Base class. Subclasses declare dataclass fields and a `__call__`.

    Every subclass becomes a dataclass with one more keyword field, `name`,
    appended after its own fields."""

    _scope: Optional[_Scope] = None
    _remat: bool = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__dataclass_fields__" not in cls.__dict__:
            ann = cls.__dict__.get("__annotations__", {})
            inherited = any("name" in getattr(b, "__dataclass_fields__", {})
                            for b in cls.__mro__[1:])
            if not inherited:
                ann = dict(ann)
                ann["name"] = "Optional[str]"
                cls.__annotations__ = ann
                cls.name = None
            dataclasses.dataclass(cls, eq=False)
        if "__call__" in cls.__dict__:
            cls.__call__ = _wrap_call(cls.__dict__["__call__"])

    # -- inside a call -----------------------------------------------------

    def param(self, name: str, init_fn: Callable, *args):
        scope = self._scope
        frame = scope.frame
        params = scope.collection("params", create=frame.initializing)
        if params is not None and name in params:
            return params[name]
        if not frame.initializing:
            raise KeyError(
                f"parameter {'/'.join(scope.path + (name,))} is missing "
                "from the variables passed to apply")
        key = jax.random.fold_in(frame.rngs["params"],
                                 _path_hash(scope.key_path(name)))
        params[name] = value = init_fn(key, *args)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *args
                 ) -> _Variable:
        scope = self._scope
        existing = scope.collection(col, create=False)
        if existing is None or name not in existing:
            if not scope.frame.is_mutable(col):
                raise KeyError(
                    f"variable {col}/{'/'.join(scope.path + (name,))} is "
                    "missing from the variables passed to apply")
            scope.collection(col, create=True)[name] = init_fn(*args)
        return _Variable(scope, col, name)

    def make_rng(self, name: str):
        scope = self._scope
        frame = scope.frame
        if name not in frame.rngs:
            raise KeyError(f"apply needs rngs={{{name!r}: key}}")
        path = scope.key_path()
        n = frame.rng_counts.get((path, name), 0)
        frame.rng_counts[(path, name)] = n + 1
        key = jax.random.fold_in(frame.rngs[name], _path_hash(path))
        return jax.random.fold_in(key, n)

    def is_initializing(self) -> bool:
        return self._scope.frame.initializing

    @property
    def variables(self) -> Dict[str, dict]:
        scope = self._scope
        out = {}
        for col in scope.frame.variables:
            d = scope.collection(col, create=False)
            if d is not None:
                out[col] = d
        return out

    # -- entry points ------------------------------------------------------

    def _run(self, frame: _Frame, args, kwargs):
        m = copy.copy(self)
        m._scope = _Scope(frame, ())
        return m(*args, **kwargs)

    def init(self, rngs, *args, **kwargs) -> Dict[str, dict]:
        """Create the variables by running `__call__` once. `rngs` is a key
        (used for "params") or a dict of keys by stream name."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, dict(rngs), True, True)
        self._run(frame, args, kwargs)
        return frame.variables

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        """Run `__call__` with `variables`. With `mutable` (a collection name,
        a list of names, or True) returns (output, {collection: updated})."""
        frame = _Frame(_copy_dicts(dict(variables)), dict(rngs or {}),
                       mutable, False)
        out = self._run(frame, args, kwargs)
        if not mutable:
            return out
        if mutable is True:
            cols = list(frame.variables)
        elif isinstance(mutable, str):
            cols = [mutable]
        else:
            cols = list(mutable)
        return out, {c: frame.variables.get(c, {}) for c in cols}


def remat(cls):
    """`cls` with its `__call__` rematerialised in the backward pass."""
    return type(cls.__name__, (cls,), {"_remat": True,
                                       "__module__": cls.__module__})


# Parameter initializers, (key, shape, dtype) -> array.

def zeros(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def ones(key, shape, dtype=jnp.float32):
    return jnp.ones(shape, dtype)


def constant(value):
    def init(key, shape, dtype=jnp.float32):
        return jnp.full(shape, value, dtype)
    return init


def uniform(bound: float):
    """U(-bound, bound): torch's default conv init for weights and biases."""
    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)
    return init
