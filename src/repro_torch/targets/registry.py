"""Target registry — the agile-retargeting entry point (paper Sec. V).

The paper's porting story is that supporting a new heterogeneous SoC
needs exactly one declarative hardware-model file and **zero** engine
changes.  This module is what makes that story enforceable rather than
aspirational: every target is a named factory in one process-wide
registry, and every pipeline entry point (``dispatch``, ``lower``, the
examples, ``benchmarks/run.py``) accepts a target *name* resolved here.
The conformance suite (``tests/conformance/``) then parametrizes over
:func:`list_targets` so any registered target — built-in or out-of-tree —
is held to the full pipeline contract automatically.

Out-of-tree targets plug in two ways, both without touching this repo:

* **plugin files / modules** — set ``MATCH_TARGET_PLUGINS`` to an
  ``os.pathsep``-separated list of ``.py`` file paths or importable
  module names; each is loaded once and is expected to call
  :func:`register_target` at import time;
* **entry points** — distributions may advertise factories under the
  ``match_repro.targets`` group (``importlib.metadata`` entry points);
  each entry point is registered under its advertised name.

Calibration: :func:`get_target` accepts ``profile=`` (a
``repro_torch.calibrate.CalibrationProfile``, a path to one, or a raw mapping)
and overlays the fitted parameter overrides on the declared target.
When no explicit profile is passed, the ``MATCH_CALIBRATION_PROFILE``
environment variable supplies a default profile file; an env profile
that is corrupt, stale, or fitted for a *different* target warns (or is
skipped) and the declared model is used — calibration must never break
a compile.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import os
import threading
import warnings
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.target import MatchTarget

__all__ = [
    "TargetRegistryError",
    "register_target",
    "unregister_target",
    "get_target",
    "resolve_target",
    "list_targets",
    "target_info",
    "load_plugins",
    "PLUGIN_ENV",
    "ENTRY_POINT_GROUP",
]

PLUGIN_ENV = "MATCH_TARGET_PLUGINS"
ENTRY_POINT_GROUP = "match_repro.targets"


class TargetRegistryError(KeyError):
    """Unknown target name, or a conflicting registration."""


@dataclass(frozen=True)
class _Entry:
    name: str
    factory: Callable[..., MatchTarget]
    description: str = ""
    aliases: tuple[str, ...] = ()
    source: str = "builtin"


_REGISTRY: dict[str, _Entry] = {}
_ALIASES: dict[str, str] = {}
_LOCK = threading.RLock()
_PLUGINS_LOADED = False


def register_target(
    name: str,
    factory: Callable[..., MatchTarget],
    *,
    aliases: tuple[str, ...] | list[str] = (),
    description: str = "",
    source: str = "builtin",
    overwrite: bool = False,
) -> None:
    """Register ``factory`` (a zero-/keyword-arg callable returning a fresh
    :class:`~repro_torch.core.target.MatchTarget`) under ``name``.

    Factories — not instances — are registered so every :func:`get_target`
    call returns an independent target (pattern tables and module lists
    are mutable).  Re-registering an existing name raises unless
    ``overwrite=True`` (plugins may deliberately shadow a builtin).
    """
    if not name or not isinstance(name, str):
        raise TargetRegistryError(f"invalid target name {name!r}")
    if not callable(factory):
        raise TargetRegistryError(f"factory for {name!r} is not callable: {factory!r}")
    with _LOCK:
        taken = name in _REGISTRY or name in _ALIASES
        if taken and not overwrite:
            raise TargetRegistryError(
                f"target {name!r} is already registered (pass overwrite=True to replace)"
            )
        for a in aliases:
            owner = _ALIASES.get(a) or (a if a in _REGISTRY else None)
            if owner and owner != name and not overwrite:
                raise TargetRegistryError(
                    f"alias {a!r} already points at target {owner!r}"
                )
        # the new name may currently be an alias of another target; an
        # overwrite claims it as a canonical name (else lookups would keep
        # resolving through the stale alias and never reach this entry)
        prev_owner = _ALIASES.pop(name, None)
        if prev_owner and prev_owner in _REGISTRY:
            pe = _REGISTRY[prev_owner]
            _REGISTRY[prev_owner] = dataclasses.replace(
                pe, aliases=tuple(x for x in pe.aliases if x != name)
            )
        # overwriting: retire the replaced entry's aliases so they cannot
        # dangle (or be deleted out from under the new owner later)
        old = _REGISTRY.get(name)
        if old is not None:
            for a in old.aliases:
                if _ALIASES.get(a) == name:
                    _ALIASES.pop(a, None)
        # alias takeover: strip the alias from its previous owner's record
        for a in aliases:
            if a == name:
                continue
            prev = _ALIASES.get(a)
            if prev and prev != name and prev in _REGISTRY:
                pe = _REGISTRY[prev]
                _REGISTRY[prev] = dataclasses.replace(
                    pe, aliases=tuple(x for x in pe.aliases if x != a)
                )
            # claiming an existing canonical name as an alias shadows that
            # target completely: retire its entry (and its own aliases) so
            # list_targets() and resolution stay consistent
            shadowed = _REGISTRY.pop(a, None)
            if shadowed is not None:
                for al in shadowed.aliases:
                    if _ALIASES.get(al) == a:
                        _ALIASES.pop(al, None)
        _REGISTRY[name] = _Entry(name, factory, description, tuple(aliases), source)
        for a in aliases:
            _ALIASES[a] = name


def unregister_target(name: str) -> None:
    """Remove a target (and its aliases); silently ignores unknown names.
    Mainly for tests exercising the plugin path."""
    with _LOCK:
        entry = _REGISTRY.pop(name, None)
        if entry is not None:
            for a in entry.aliases:
                if _ALIASES.get(a) == name:
                    _ALIASES.pop(a, None)


def _canonical(name: str) -> str:
    return _ALIASES.get(name, name)


# "no profile argument given": distinct from profile=None (explicitly
# uncalibrated), which also suppresses the MATCH_CALIBRATION_PROFILE env
# default.
_PROFILE_UNSET = object()


# kept in sync with repro_torch.calibrate.profile.PROFILE_ENV — spelled out
# here so the common no-calibration path never imports repro_torch.calibrate
_PROFILE_ENV = "MATCH_CALIBRATION_PROFILE"


def _calibrated(target: MatchTarget, profile) -> MatchTarget:
    """Overlay a calibration profile on a freshly built target.

    ``profile is _PROFILE_UNSET`` consults ``MATCH_CALIBRATION_PROFILE``;
    an env-sourced profile fitted for a different target is skipped
    silently (one env var serves multi-target runs like the conformance
    matrix), while an *explicitly passed* mismatched profile raises.
    """
    from_env = profile is _PROFILE_UNSET
    if from_env:
        path = os.environ.get(_PROFILE_ENV)
        if not path:
            return target
        profile = path
    if profile is None:
        return target
    try:
        from repro_torch.calibrate.profile import (
            apply_profile,
            coerce_profile,
            profile_matches_target,
        )
    except Exception as e:  # env-requested calibration must never break compiles
        if from_env:
            warnings.warn(
                f"{_PROFILE_ENV} is set but repro_torch.calibrate failed to import "
                f"({e}); using the declared hardware model"
            )
            return target
        raise
    prof = coerce_profile(profile)  # warns + None on corrupt/stale files
    if prof is None:
        return target
    if not profile_matches_target(prof, target.name):
        if from_env:
            return target
        raise ValueError(
            f"calibration profile is for target {prof.target!r}, not {target.name!r}"
        )
    return apply_profile(target, prof)


def get_target(name: str, *, profile=_PROFILE_UNSET, **factory_kwargs) -> MatchTarget:
    """Instantiate the registered target ``name`` (aliases resolve).

    Unknown names first trigger plugin loading (``MATCH_TARGET_PLUGINS``
    + entry points) so an out-of-tree target resolves lazily, then raise
    :class:`TargetRegistryError` listing everything that *is* registered.

    ``profile`` overlays fitted calibration overrides (see
    :mod:`repro_torch.calibrate`): a ``CalibrationProfile``, a path, or a raw
    mapping.  Omitted, the ``MATCH_CALIBRATION_PROFILE`` env var is
    consulted; ``profile=None`` forces the declared (uncalibrated) model.
    """
    with _LOCK:
        key = _canonical(name)
        entry = _REGISTRY.get(key)
    if entry is None:
        load_plugins()
        with _LOCK:
            key = _canonical(name)
            entry = _REGISTRY.get(key)
    if entry is None:
        raise TargetRegistryError(
            f"unknown target {name!r}; registered targets: {', '.join(list_targets())}"
        )
    target = entry.factory(**factory_kwargs)
    if not isinstance(target, MatchTarget):
        raise TargetRegistryError(
            f"factory for {name!r} returned {type(target).__name__}, not MatchTarget"
        )
    return _calibrated(target, profile)


def resolve_target(target: "MatchTarget | str") -> MatchTarget:
    """Pass a :class:`MatchTarget` through; resolve a name via the registry."""
    if isinstance(target, MatchTarget):
        return target
    return get_target(target)


def list_targets() -> list[str]:
    """Sorted canonical names of every registered target (plugins included)."""
    load_plugins()
    with _LOCK:
        return sorted(_REGISTRY)


def target_info(name: str) -> dict:
    """Metadata for one registered target (description, aliases, source).
    Unknown names trigger lazy plugin loading, exactly like get_target."""
    with _LOCK:
        entry = _REGISTRY.get(_canonical(name))
    if entry is None:
        load_plugins()
        with _LOCK:
            entry = _REGISTRY.get(_canonical(name))
    if entry is None:
        raise TargetRegistryError(f"unknown target {name!r}")
    return {
        "name": entry.name,
        "description": entry.description,
        "aliases": entry.aliases,
        "source": entry.source,
    }


# ---------------------------------------------------------------------------
# Plugin loading (out-of-tree targets)
# ---------------------------------------------------------------------------


def _load_plugin_file(path: str) -> None:
    spec = importlib.util.spec_from_file_location(
        f"match_target_plugin_{abs(hash(path)):x}", path
    )
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load plugin file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)


def _load_entry_points() -> None:
    try:
        from importlib.metadata import entry_points
    except ImportError:  # pragma: no cover
        return
    try:
        eps = entry_points(group=ENTRY_POINT_GROUP)
    except TypeError:  # pragma: no cover - pre-3.10 selectable API
        eps = entry_points().get(ENTRY_POINT_GROUP, ())
    for ep in eps:
        try:
            with _LOCK:
                if ep.name in _REGISTRY or ep.name in _ALIASES:
                    continue  # already registered (e.g. repeated load)
            factory = ep.load()
            register_target(ep.name, factory, source=f"entry-point:{ep.value}")
        except Exception as e:  # a broken plugin must not break the pipeline
            warnings.warn(f"target entry point {ep.name!r} failed to load: {e}")


def load_plugins(force: bool = False) -> None:
    """Load out-of-tree targets: ``MATCH_TARGET_PLUGINS`` files/modules and
    ``match_repro.targets`` entry points.  Idempotent unless ``force``.

    A plugin that fails to import warns and is skipped — a broken
    out-of-tree file must never take down compiles of builtin targets.
    """
    global _PLUGINS_LOADED
    # the whole load runs under the (re-entrant) lock: a concurrent
    # get_target blocks until loading finishes instead of observing a
    # half-populated registry, and plugins calling register_target or
    # list_targets during their own import re-enter safely.
    with _LOCK:
        if _PLUGINS_LOADED and not force:
            return
        _PLUGINS_LOADED = True
        for item in (os.environ.get(PLUGIN_ENV) or "").split(os.pathsep):
            item = item.strip()
            if not item:
                continue
            try:
                if item.endswith(".py") or os.sep in item:
                    _load_plugin_file(item)
                else:
                    importlib.import_module(item)
            except Exception as e:
                # includes TargetRegistryError from a name collision mid-file
                # (plugins that expect reloads should pass overwrite=True):
                # anything the plugin registered before the failure stays,
                # the rest of that file is lost — say so instead of hiding it
                warnings.warn(f"target plugin {item!r} failed to load: {e}")
        _load_entry_points()
