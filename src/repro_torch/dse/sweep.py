"""Sweep specification: design points over a topology's traced params.
Counterpart of ``repro.dse.sweep``: the points, their validation and
their errors are the reference's word for word; the param trees are torch
tensors on the simulation's device.

A *design point* is a flat dict mapping axis paths to values.  Paths name
leaves of the engine's :class:`~repro.core.SimParams` pytree (traced —
hundreds of points share one compiled simulation) or, with the ``static.``
prefix, keyword arguments of the caller's build function (structural —
each distinct combination forces a rebuild/compile and forms its own
vmapped batch):

  ``conn_latency``            all connection latencies (cycles, >= 1)
  ``conn_latency[i]``         one connection (negative i counts from end)
  ``period.<kind>``           tick period of every instance of a kind
  ``period.<kind>[i]``        tick period of one instance
  ``kind.<kind>.<leaf>``      an opt-in model param (``ComponentKind.params``
                              pytree; nested dicts use dotted paths)
  ``static.<kwarg>``          build-function keyword (e.g. super_epoch)
  ``shape.<axis>``            a topology-family shape axis (instance
                              counts / wiring): lowered to traced activity
                              *masks* over one padded maximum-shape build,
                              NOT to per-shape compile groups (DSE.md
                              "Topology families")

:class:`SweepSpec` holds an ordered tuple of points, constructed by
``grid`` (cartesian product), ``random`` (uniform/log-uniform/choice
sampling), or ``explicit``.  ``split_static`` groups points by their
static-axis assignment so the runner compiles once per group; point order
within the spec is the canonical result order.

Axis paths can be checked *eagerly* — before any build or compile —
against the target simulation: pass ``validate_for=sim`` (or a
``TopologyFamily``) to a constructor, or call ``spec.validate(target)``;
unknown kinds/leaves raise a ``ValueError`` naming the bad path and the
valid axes instead of a deep ``KeyError`` mid-``run_sweep`` (which also
validates each compile group up front).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import zlib
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import SimParams
from repro_torch.core.engine import tree_map

STATIC_PREFIX = "static."
SHAPE_PREFIX = "shape."

_INDEXED = re.compile(r"^(?P<base>.*?)\[(?P<ix>-?\d+)\]$")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """An ordered set of design points (dicts of axis path -> value)."""

    points: tuple[dict, ...]

    def __len__(self):
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def grid(axes: dict[str, Sequence], validate_for=None) -> "SweepSpec":
        """Cartesian product of the axis value lists (insertion order:
        last axis varies fastest).  ``validate_for`` (a ``Simulation`` or
        ``TopologyFamily``) checks the axis paths eagerly at construction."""
        names = list(axes)
        combos = itertools.product(*(list(axes[n]) for n in names))
        spec = SweepSpec(tuple(dict(zip(names, c)) for c in combos))
        if validate_for is not None:
            spec.validate(validate_for)
        return spec

    @staticmethod
    def random(axes: dict[str, Any], n: int, seed: int = 0,
               validate_for=None) -> "SweepSpec":
        """``n`` points sampled independently per axis.  Axis specs:
        ``(lo, hi)`` uniform — float endpoints sample uniform floats,
        int endpoints sample uniform ints on the *inclusive* range —
        ``(lo, hi, 'log')`` log-uniform float, or a list/tuple of >2 (or
        non-numeric) entries = uniform choice.

        Each axis draws from its own RNG substream keyed on
        ``(seed, axis name)``: the values one axis yields under a seed
        never depend on the other axes' spec styles, their count, or
        dict order, and int axes come back as Python ints (JSON-clean
        rows; pinned by ``tests/dse/test_sweep_spec.py``).
        """
        cols = {}
        for name, spec in axes.items():
            rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
            kind, *args = parse_axis_spec(spec)
            if kind == "log":
                lo, hi = args
                cols[name] = [float(v) for v in np.exp(rng.uniform(
                    np.log(lo), np.log(hi), n))]
            elif kind == "int":
                lo, hi = args
                cols[name] = [int(v) for v in rng.integers(lo, hi + 1, n)]
            elif kind == "float":
                lo, hi = args
                cols[name] = [float(v) for v in rng.uniform(lo, hi, n)]
            else:
                values = args[0]
                cols[name] = [_py_scalar(values[int(i)])
                              for i in rng.integers(0, len(values), n)]
        out = SweepSpec(tuple(
            {name: cols[name][i] for name in axes} for i in range(n)))
        if validate_for is not None:
            out.validate(validate_for)
        return out

    @staticmethod
    def explicit(points: Iterable[dict], validate_for=None,
                 ragged: bool = False) -> "SweepSpec":
        """An ordered spec from caller-supplied point dicts.

        Points that share a ``static.*`` assignment stack into one
        vmapped compile group, so they must assign the same axis keys —
        a missing or extra key would otherwise surface much later as an
        opaque stacking/lookup failure deep in a sweep or search round.
        The mismatch raises here instead, naming the offending point
        index and keys.  Points in *different* static groups may use
        different traced axes (each group stacks separately).
        ``ragged=True`` skips the check entirely.
        """
        pts = tuple(dict(p) for p in points)
        if not ragged:
            groups: dict[frozenset, tuple[int, set]] = {}
            for i, p in enumerate(pts):
                static = frozenset(kv for kv in p.items()
                                   if kv[0].startswith(STATIC_PREFIX))
                j, keys0 = groups.setdefault(static, (i, set(p)))
                if set(p) != keys0:
                    missing = sorted(keys0 - set(p))
                    extra = sorted(set(p) - keys0)
                    raise ValueError(
                        f"explicit point {i} has inconsistent axis keys "
                        f"(missing {missing}, extra {extra} vs point "
                        f"{j}'s {sorted(keys0)}, the first point of its "
                        "static group); points that stack into one "
                        "compile group must assign identical axes "
                        "(ragged=True skips this check)")
        spec = SweepSpec(pts)
        if validate_for is not None:
            spec.validate(validate_for)
        return spec

    # -- eager validation --------------------------------------------------
    @property
    def axes(self) -> list[str]:
        """Union of axis paths across points, in first-appearance order."""
        seen: list[str] = []
        for pt in self.points:
            for k in pt:
                if k not in seen:
                    seen.append(k)
        return seen

    def has_shape_axes(self) -> bool:
        return any(k.startswith(SHAPE_PREFIX) for k in self.axes)

    def summary(self) -> dict:
        """A small JSON-safe description of the spec — axis names, value
        counts per axis, point count — for telemetry (``sweep.start``
        events carry it) and logs.  Never materializes values: a
        192-point grid summarizes to a few dozen bytes.
        """
        counts: dict[str, set] = {}
        for pt in self.points:
            for k, v in pt.items():
                counts.setdefault(k, set()).add(
                    v if isinstance(v, (int, float, str, bool)) else str(v))
        return {"n_points": len(self.points),
                "axes": {k: len(vs) for k, vs in counts.items()}}

    def validate(self, target, static_ok: Sequence[str] | None = None
                 ) -> "SweepSpec":
        """Check every axis path against ``target`` (a ``Simulation`` or a
        ``TopologyFamily``) *before* anything is built or compiled.

        Raises ``ValueError`` naming each bad path and the valid axes —
        instead of the deep ``KeyError`` an unknown kind/leaf (e.g.
        ``period.l1x``) would otherwise surface mid-``run_sweep``.
        ``static_ok`` (optional) whitelists ``static.*`` kwarg names
        (``run_sweep`` derives it from the build function's signature).
        Returns ``self`` for chaining.
        """
        family = getattr(target, "shape_max", None)
        sim = target.sim if family is not None else target
        params = sim.default_params()
        errors = []
        for path in self.axes:
            if path.startswith(STATIC_PREFIX):
                name = path[len(STATIC_PREFIX):]
                if static_ok is not None and name not in static_ok:
                    errors.append(f"{path!r}: build function accepts no "
                                  f"keyword {name!r} "
                                  f"(have {sorted(static_ok)})")
            elif path.startswith(SHAPE_PREFIX):
                name = path[len(SHAPE_PREFIX):]
                if family is None:
                    errors.append(
                        f"{path!r}: shape axes need a topology family "
                        "(a build function returning TopologyFamily); "
                        "this target is a plain Simulation")
                elif name not in family:
                    errors.append(f"{path!r}: unknown family shape axis "
                                  f"(have {sorted(family)})")
            else:
                err = axis_error(params, path)
                if err:
                    errors.append(err)
        if errors:
            raise ValueError(
                "invalid sweep axes:\n  " + "\n  ".join(errors)
                + "\nvalid axes for this target:\n  "
                + "\n  ".join(valid_axes(params, family)))
        return self

    # -- static/traced split ----------------------------------------------
    def split_static(self):
        """Group points by their ``static.*`` assignment.

        Returns ``[(static_kwargs, indices, traced_points), ...]`` in first-
        appearance order; ``indices`` map each group's points back to spec
        order.
        """
        groups: dict[tuple, tuple[dict, list, list]] = {}
        for i, pt in enumerate(self.points):
            static = {k[len(STATIC_PREFIX):]: v for k, v in pt.items()
                      if k.startswith(STATIC_PREFIX)}
            traced = {k: v for k, v in pt.items()
                      if not k.startswith(STATIC_PREFIX)}
            key = tuple(sorted(static.items()))
            if key not in groups:
                groups[key] = (static, [], [])
            groups[key][1].append(i)
            groups[key][2].append(traced)
        return list(groups.values())


# ---------------------------------------------------------------------------
def _py_scalar(v):
    """Numpy scalar -> plain Python scalar (rows stay JSON-clean)."""
    return v.item() if isinstance(v, np.generic) else v


def parse_axis_spec(spec) -> tuple:
    """Classify one :meth:`SweepSpec.random` axis spec — the single
    source of truth for spec detection, shared with the BO surrogate's
    axis encoders (:func:`repro_torch.dse.search.bo._axis_codec`) so sampling
    and encoding can never drift apart.

    Returns ``("log", lo, hi)``, ``("int", lo, hi)`` (both endpoints
    Python ints — the *inclusive* integer range), ``("float", lo, hi)``,
    or ``("choice", values)``.
    """
    spec = tuple(spec)
    is_range = (len(spec) in (2, 3)
                and all(isinstance(v, (int, float))
                        and not isinstance(v, bool)
                        for v in spec[:2])
                and (len(spec) == 2 or spec[2] == "log"))
    if not is_range:
        return ("choice", spec)
    if len(spec) == 3:
        return ("log", float(spec[0]), float(spec[1]))
    if all(isinstance(v, int) for v in spec[:2]):
        return ("int", int(spec[0]), int(spec[1]))
    return ("float", float(spec[0]), float(spec[1]))


def split_shape(point: dict) -> tuple[dict, dict]:
    """Split one design point into (shape assignment, traced assignments).

    ``shape.<axis>`` keys come back stripped of their prefix; everything
    else (the traced axes) is returned untouched for ``apply_point``.
    """
    shape = {k[len(SHAPE_PREFIX):]: v for k, v in point.items()
             if k.startswith(SHAPE_PREFIX)}
    traced = {k: v for k, v in point.items()
              if not k.startswith(SHAPE_PREFIX)}
    return shape, traced


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], f"{prefix}{k}.")
        return out
    return [prefix[:-1]] if prefix else []


def valid_axes(params: SimParams, shape_axes=None) -> list[str]:
    """Human-readable list of every sweepable axis of a target."""
    axes = ["conn_latency", "conn_latency[i]"]
    for k in sorted(params.periods):
        axes += [f"period.{k}", f"period.{k}[i]"]
    for k in sorted(params.kind):
        for leaf in _leaf_paths(params.kind[k]):
            axes.append(f"kind.{k}.{leaf}")
    for name in sorted(shape_axes or ()):
        axes.append(f"shape.{name}")
    axes.append("static.<build kwarg>")
    return axes


def axis_error(params: SimParams, path: str) -> str | None:
    """``None`` if ``path`` names a traced leaf of ``params``, else a
    one-line description of why it does not."""
    m = _INDEXED.match(path)
    base, ix = (m["base"], int(m["ix"])) if m else (path, None)

    def ix_ok(n):
        if ix is not None and not -n <= ix < n:
            return f"{path!r}: index {ix} out of range for [{n}]"
        return None

    if base == "conn_latency":
        return ix_ok(params.conn_latency.shape[0])
    if base.startswith("period."):
        kname = base[len("period."):]
        if kname not in params.periods:
            return (f"{path!r}: unknown kind {kname!r} "
                    f"(have {sorted(params.periods)})")
        return ix_ok(params.periods[kname].shape[0])
    if base.startswith("kind."):
        if ix is not None:
            return f"{path!r}: kind-param axes are not indexable"
        kname, _, leaf = base[len("kind."):].partition(".")
        if kname not in params.kind or not params.kind[kname]:
            return (f"{path!r}: kind {kname!r} has no params "
                    f"(kinds with params: "
                    f"{sorted(k for k, v in params.kind.items() if v)})")
        tree = params.kind[kname]
        for key in leaf.split("."):
            if not isinstance(tree, dict) or key not in tree:
                return (f"{path!r}: no param leaf {leaf!r} on kind "
                        f"{kname!r} (have {_leaf_paths(params.kind[kname])})")
            tree = tree[key]
        return None
    return f"unknown sweep axis {path!r}"


def _set_indexed(arr, path, ix, value):
    n = arr.shape[0]
    assert -n <= ix < n, f"{path}: index {ix} out of range for [{n}]"
    out = arr.clone()
    out[ix] = torch.as_tensor(value, dtype=arr.dtype)
    return out


def apply_point(params: SimParams, point: dict) -> SimParams:
    """Return ``params`` with one design point's traced assignments applied.

    Runs at build time, outside any captured block (clones plus indexed
    sets on tiny tensors);
    unknown paths raise ``KeyError`` so typos fail loudly before compile.
    """
    conn = params.conn_latency
    periods = dict(params.periods)
    kind = {k: v for k, v in params.kind.items()}
    for path, value in point.items():
        if path.startswith(STATIC_PREFIX):
            raise KeyError(f"static axis {path!r} reached apply_point — "
                           "route points through SweepSpec.split_static")
        if path.startswith(SHAPE_PREFIX):
            raise KeyError(f"shape axis {path!r} reached apply_point — "
                           "route points through split_shape and a "
                           "TopologyFamily (masks, not param leaves)")
        m = _INDEXED.match(path)
        base, ix = (m["base"], int(m["ix"])) if m else (path, None)
        if base == "conn_latency":
            if ix is None:
                conn = torch.full_like(conn, float(value))
            else:
                conn = _set_indexed(conn, path, ix, value)
        elif base.startswith("period."):
            kname = base[len("period."):]
            if kname not in periods:
                raise KeyError(f"{path!r}: unknown kind {kname!r} "
                               f"(have {sorted(periods)})")
            if ix is None:
                periods[kname] = torch.full_like(periods[kname],
                                                 float(value))
            else:
                periods[kname] = _set_indexed(periods[kname], path, ix, value)
        elif base.startswith("kind."):
            kname, _, leaf_path = base[len("kind."):].partition(".")
            if kname not in kind or not leaf_path:
                raise KeyError(f"{path!r}: unknown kind-param path "
                               f"(kinds with params: "
                               f"{sorted(k for k, v in kind.items() if v)})")
            kind[kname] = _set_leaf(kind[kname], leaf_path.split("."),
                                    value, path)
        else:
            raise KeyError(f"unknown sweep axis {path!r}")
    return dataclasses.replace(params, conn_latency=conn, periods=periods,
                               kind=kind)


def _set_leaf(tree, keys, value, path):
    if not isinstance(tree, dict) or keys[0] not in tree:
        raise KeyError(f"{path!r}: no param leaf {'.'.join(keys)!r} "
                       f"(have {sorted(tree) if isinstance(tree, dict) else tree})")
    out = dict(tree)
    if len(keys) == 1:
        old = out[keys[0]]
        out[keys[0]] = torch.as_tensor(value, dtype=old.dtype,
                                       device=old.device)
    else:
        out[keys[0]] = _set_leaf(out[keys[0]], keys[1:], value, path)
    return out


def stack_trees(trees: Sequence) -> Any:
    """Stack a list of identically-structured pytrees into one batch
    (leading axis B), materializing fresh buffers per leaf
    (``torch.stack``: no lane aliases another lane or an input)."""
    assert trees, "empty batch"
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def stack_params(plist: Sequence[SimParams]) -> SimParams:
    """Stack per-point :class:`SimParams` into one batch (leading axis B)."""
    return stack_trees(plist)


def build_param_batch(sim, points: Sequence[dict]) -> SimParams:
    """``sim.default_params()`` + each point's assignments, stacked."""
    base = sim.default_params()
    return stack_params([apply_point(base, pt) for pt in points])
