"""Small shared helpers of the port's control plane: a copy of
:mod:`tony_tpu.util` (reference: the ``com.linkedin.tony.util.Utils``
grab-bag, kept deliberately tiny — SURVEY.md §2.1). Standard library
only."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

# The repo/package root: parent of the tony_tpu_torch package directory.
PKG_ROOT = str(Path(__file__).resolve().parent.parent)


def default_workdir() -> Path:
    """The client job workdir — TONY_WORK_DIR env or ~/.tony-tpu/jobs,
    the reference's (the two CLIs share one job tree)."""
    return Path(os.environ.get("TONY_WORK_DIR",
                               Path.home() / ".tony-tpu" / "jobs"))


def child_pythonpath(env: Dict[str, str]) -> str:
    """PYTHONPATH for a child process that must import ``tony_tpu_torch`` even when
    the parent loaded it off ``sys.path`` (tests / source checkout) rather
    than an installed package: prepend the package root, dedupe.

    Deliberately does NOT carry site-packages: PYTHONPATH reaches the USER
    process, where host site dirs would shadow a job venv's packages. The
    ``python -S`` control-plane processes get their site dirs via
    :func:`control_plane_site_env` / :func:`restore_site_dirs` instead."""
    parts = [PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p and p != PKG_ROOT]
    return os.pathsep.join(parts)


# AM/executor processes launch with `python -S`: they are stdlib-only, and
# skipping the site import (and any sitecustomize hooks an ML stack
# installs) is pure submit→running latency. Their LAZY heavyweight imports
# (discovery's opt-in torch census) still need site-packages, carried in this env var and restored with
# site.addsitedir (which, unlike PYTHONPATH, also processes .pth files —
# pip --user and editable installs keep working).
ENV_SITE_DIRS = "TONY_SITE_DIRS"


def control_plane_site_env() -> Dict[str, str]:
    """Env entry shipping this interpreter's site dirs to a ``-S`` child.
    Reuses an inherited value (an AM is itself a ``-S`` child and must
    forward what the client computed under full site)."""
    import site

    existing = os.environ.get(ENV_SITE_DIRS)
    if existing:
        return {ENV_SITE_DIRS: existing}
    dirs = []
    try:
        dirs += site.getsitepackages()
    except AttributeError:        # some embedded interpreters
        pass
    try:
        user = site.getusersitepackages()
        if user:
            dirs.append(user)
    except AttributeError:
        pass
    dirs = [d for d in dirs if os.path.isdir(d)]
    return {ENV_SITE_DIRS: os.pathsep.join(dirs)} if dirs else {}


def restore_site_dirs() -> None:
    """First statement of a ``-S`` control-plane ``__main__``: register the
    shipped site dirs so lazy imports resolve, WITHOUT running the
    sitecustomize hooks ``-S`` exists to skip."""
    import site

    for d in os.environ.get(ENV_SITE_DIRS, "").split(os.pathsep):
        if d:
            site.addsitedir(d)


def normalize_serve_telemetry(raw: Dict) -> Dict[str, object]:
    """One normalization for the serve heartbeat schema, shared by the
    executor's stats-file reader and the session's heartbeat ingest so
    the two layers cannot drift: scalars become floats, list values
    (the router's ``prefix_digest`` block-key list and the parked-
    conversation ``parked_digest`` list) become string lists, and
    non-numeric strings (the disaggregated replica ``role``
    — the schema's second non-scalar) pass through as strings, and the
    per-tenant ``tenants`` breakdown (the reference's serve.qos — a dict of
    per-tenant dicts of scalars, the schema's ONE sanctioned nesting)
    normalizes recursively. Numeric strings still normalize to float,
    so a stats writer that stringified a counter keeps its historical
    behavior. Raises on anything else (deeper nesting, None), so both
    callers keep their own advisory-telemetry failure handling."""
    def norm(v: object, depth: int) -> object:
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        if isinstance(v, dict):
            if depth >= 3:
                raise TypeError(
                    "serve telemetry nests deeper than the schema's "
                    "tenants breakdown (dict of dicts of scalars)")
            return {str(k): norm(x, depth + 1) for k, x in v.items()}
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return v
        return float(v)

    return {str(k): norm(v, 1) for k, v in dict(raw).items()}
