"""Checkpoint path and marker protocol, free of torch.

Port of ``hetu_galvatron_tpu/runtime/ckpt_paths.py``: ``step_of`` :44,
``is_committed`` :55, ``committed_steps`` :63, ``latest_committed_step``
:84, ``commit_wall_time`` :92, ``atomic_write_json`` :104,
``try_read_json`` :117, ``try_read_meta`` :133, ``stored_world_of`` :143
and the ``RESUME_PIN`` lease (``write_resume_pin`` :158,
``read_resume_pin`` :171, ``clear_resume_pin`` :189), with the same names
on disk.

The atomic-commit protocol (``step_<n>.tmp`` staging -> fsynced
``COMMITTED`` marker -> rename) lives in ``runtime/checkpoint.py``, but
the cross-process supervisor (``runtime/supervisor.ProcessSupervisor``,
``cli/supervise.py``) must speak it without importing torch, which its
children need the card for. So the pure-path half lives here: step-name
parsing, commit detection, newest-committed selection, safe meta reads,
atomic JSON writes, and the cross-process ``RESUME_PIN`` lease that closes
the GC-vs-concurrent-resume race across processes (the in-process half is
``checkpoint._RESUME_PROTECTED``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

# A step dir without this marker is partial garbage from a mid-save
# crash: never selected, eligible for GC. (The marker, not just the
# rename, because FUSE-mounted object stores can surface a directory
# rename non-atomically.)
COMMIT_MARKER = "COMMITTED"
TMP_SUFFIX = ".tmp"
OLD_SUFFIX = ".old"  # previous committed payload during an overwrite

# Cross-process resume lease: the supervisor stamps the step dir the next
# child attempt will restore from; gc_checkpoints holds that dir out of
# the retention prune set. The pin carries a wall-clock stamp and expires
# (a crashed supervisor must not pin a step dir forever).
RESUME_PIN = "RESUME_PIN"
RESUME_PIN_TTL_S = 24 * 3600.0


def step_of(entry: str) -> Optional[int]:
    """``step_<int>`` -> int; anything else (``step_5.partial``, ``.tmp``
    staging dirs, stray names) -> None."""
    if not entry.startswith("step_"):
        return None
    suffix = entry[len("step_"):]
    if not suffix.isdigit():
        return None
    return int(suffix)


def is_committed(ckpt_dir: str) -> bool:
    """A step dir counts as committed when it carries the commit marker
    (new protocol) or a meta.json (pre-marker checkpoints, which wrote
    meta.json last)."""
    return (os.path.exists(os.path.join(ckpt_dir, COMMIT_MARKER))
            or os.path.exists(os.path.join(ckpt_dir, "meta.json")))


def committed_steps(root: str) -> List[Tuple[int, str]]:
    """Every committed ``(step, abs_dir)`` under ``root``, ascending by
    step. Partial/staging/stray entries are skipped, never raised on."""
    if not os.path.isdir(root):
        return []
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    for entry in entries:
        step = step_of(entry)
        if step is None:
            continue
        full = os.path.join(root, entry)
        if os.path.isdir(full) and is_committed(full):
            out.append((step, os.path.abspath(full)))
    out.sort()
    return out


def latest_committed_step(root: str) -> Optional[Tuple[int, str]]:
    """Newest committed ``(step, abs_dir)``, or None — the torch-free
    counterpart of ``checkpoint.latest_checkpoint`` (which additionally
    registers in-process resume protection)."""
    steps = committed_steps(root)
    return steps[-1] if steps else None


def commit_wall_time(ckpt_dir: str) -> Optional[float]:
    """Wall-clock time of the commit (the marker's mtime; meta.json for
    pre-marker checkpoints) — the supervisor's RPO clock."""
    for name in (COMMIT_MARKER, "meta.json"):
        p = os.path.join(ckpt_dir, name)
        try:
            return os.path.getmtime(p)
        except OSError:
            continue
    return None


def atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """tmp + fsync + rename — readers see the old content or the new,
    never a torn file (same discipline as the commit marker)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def try_read_json(path: str) -> Tuple[Optional[Dict[str, Any]],
                                      Optional[Exception]]:
    """Read a JSON file defensively: ``(payload, None)`` on success,
    ``(None, error)`` on absence/corruption — callers on resume paths
    must degrade, not traceback."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except Exception as e:  # noqa: BLE001 — defensive read by contract
        return None, e
    if not isinstance(payload, dict):
        return None, ValueError(f"{path}: expected a JSON object, got "
                                f"{type(payload).__name__}")
    return payload, None


def try_read_meta(ckpt_dir: str) -> Tuple[Dict[str, Any],
                                          Optional[Exception]]:
    """A step dir's meta.json, never raising: ``({}, err)`` when absent,
    unparseable, or truncated. The torch-free sibling of
    ``checkpoint.read_checkpoint_meta`` (no retry policy here — the
    supervisor polls, it does not block on backoff)."""
    meta, err = try_read_json(os.path.join(ckpt_dir, "meta.json"))
    return (meta if meta is not None else {}), err


def stored_world_of(root: str) -> Optional[int]:
    """world_size recorded by the newest commit's plan fingerprint — the
    supervisor's cross-process world probe (a topology change becomes
    visible once the new world commits, without touching the card)."""
    latest = latest_committed_step(root)
    if latest is None:
        return None
    meta, _ = try_read_meta(latest[1])
    world = (meta.get("hybrid_parallel_config") or {}).get("world_size")
    return int(world) if world is not None else None


# -- RESUME_PIN lease --------------------------------------------------------


def write_resume_pin(root: str, ckpt_dir: str, *,
                     owner: Optional[str] = None) -> str:
    """Pin ``ckpt_dir`` against retention GC before a relaunch resumes
    from it. Atomic (tmp+rename); returns the pin path."""
    pin = os.path.join(root, RESUME_PIN)
    atomic_write_json(pin, {
        "ckpt": os.path.abspath(ckpt_dir),
        "owner": owner or f"pid:{os.getpid()}",
        "t_wall": time.time(),
    })
    return pin


def read_resume_pin(root: str, *,
                    ttl_s: float = RESUME_PIN_TTL_S) -> Optional[str]:
    """The pinned step dir (abs path), or None when there is no live pin.
    An unparseable or expired pin reads as absent — a crashed supervisor
    must not protect a step dir forever."""
    payload, _ = try_read_json(os.path.join(root, RESUME_PIN))
    if not payload:
        return None
    ckpt = payload.get("ckpt")
    t_wall = payload.get("t_wall")
    if not isinstance(ckpt, str):
        return None
    if isinstance(t_wall, (int, float)) and \
            time.time() - t_wall > ttl_s:
        return None
    return ckpt


def clear_resume_pin(root: str) -> None:
    try:
        os.remove(os.path.join(root, RESUME_PIN))
    except OSError:
        pass
