"""Checkpoint save, resume and the weight bridge to the JAX package.

Port of ``hetu_galvatron_tpu/runtime/checkpoint.py``'s single-device
lifecycle: ``WorldSizeMismatchError`` :44, ``_plan_fingerprint`` :108,
``PlanMismatchError`` :121, ``_commit`` :147, ``save_checkpoint`` :172,
``wait_for_checkpoints`` :270, ``gc_checkpoints`` :330,
``latest_checkpoint`` :381, ``read_checkpoint_meta`` /
``try_read_checkpoint_meta`` :410/:428, ``committed_checkpoints`` :440,
``load_latest_resilient`` :447, ``load_checkpoint`` :502,
``AsyncCheckpointer`` :582 and ``CheckpointCadence`` :783, with the same
atomic-commit protocol on disk: a step is staged in ``step_<n>.tmp``, the
fsynced ``COMMITTED`` marker lands, then one rename publishes
``step_<n>``; a ``hooks["before_commit"](tmp_dir)`` seam sits between the
staged payload and the marker (the window a kill-mid-save drill tears).

The payload format is the port's own (the JAX package writes orbax):

* ``params.pt``: a flat dict from each leaf's dotted name
  (``models/builder.named_leaves``) to a CPU fp32 tensor;
* ``opt_state.pt``: the AdamW state (``runtime/optimizer.AdamState``):
  ``count``, the ``adam`` / ``sgd`` leaf-index lists, and ``mu.<name>`` /
  ``nu.<name>`` tensors for each Adam leaf (a plain tree of tensors, as
  the JAX tests pass, is saved by leaf name the same way);
* the pipeline engine's state (``runtime/pipeline.py``) is saved in its
  stage layout, as JAX's ``save_checkpoint(..., sp, so, hpc=hpc)``
  (``cli/train_dist.py:736-737``): the list of stage parameter trees
  (names ``<s>.<leaf>``, the tied copy ``<last>.head.whead`` among them)
  and the list of stage AdamW states (``<s>.count``, ``<s>.mu.<leaf>``,
  ...);
* the compiled pipeline's state (``runtime/compiled_pipeline.py``) in its
  stacked layout: one tree whose ``stages.<j>.<leaf>`` carry the ``[pp]``
  axis, and one AdamW state over it (``mu.stages.<j>.<leaf>``, ...);
* ``meta.json``: the JAX keys ``step``, ``hybrid_parallel_config`` (the
  plan fingerprint with ``pp_division``, ``vpp_deg`` above 1 and
  ``world_size``) and ``train_state`` (``step``, ``seed``,
  ``telemetry_step``, ``batches_consumed``, ``consumed_samples``,
  ``rerun``; the JAX goodput totals belong to the observability slice).
  A checkpoint of another stage layout, or of another engine layout
  (``spmd``, ``stages`` or ``stacked``, read from the saved leaf names:
  ``runtime/reshard.py``), raises :class:`PlanMismatchError` whether or
  not the plan is checked strictly (``runtime/reshard.resume_elastic``
  moves one between the layouts), one of another world
  :class:`WorldSizeMismatchError`.

Files are written with ``torch.save`` and read with ``torch.load(
weights_only=True, mmap=True)``, so a load maps the file rather than
reading a second host copy of it, and each leaf is copied into the live
target tensor in place. Every read and write goes through
``utils/retrying.retry_call`` (ops ``checkpoint.write``,
``checkpoint.read_meta``, ``checkpoint.restore``): the chaos harness's
transient I/O faults take the production path.

With ``ckpt.snapshot_async`` a save costs the step one on-device copy of
the parameters and the AdamW moments (``AsyncCheckpointer.snapshot``):
the copy is enqueued on the current stream, a CUDA event is recorded
after it, and the writer thread waits on that event on a stream of its
own before it copies to the host and writes. The copy is needed because
the port's optimizer updates the leaves in place: a writer reading the
live leaves would save a mixture of two steps. It holds a second copy of
the fp32 state on the card for the length of the write: 12 bytes a
parameter, 18.67 GB for the 1,556,113,920 parameters of the two-layer
Qwen2.5-7B-width drill of ``chip_smoke.py`` phase 8. ``ckpt.async_save``
takes the host copy on the step and writes on a thread, committed at the
next ``wait_for_checkpoints``.

The weight bridge (``params_from_jax`` / ``params_to_jax``,
``opt_state_from_jax`` / ``opt_state_to_jax``) converts the JAX package's
parameter tree and optax chain state to the port's, so a JAX checkpoint
restored by the JAX package crosses over (and back) in a test that
imports both. Both packages keep the same tree and layouts (``embed.wte
[Vp, H]`` with the padded vocab rows, ``embed.wpe``, ``layers[i].{ln1,
attn.{wqkv, bqkv, wo, bo}, ln2, mlp.{win, bin, wout, bout}}``, an MoE
layer's ``moe.{router, win, wout, shared.{win, bin, wout, bout},
expert_bias}`` in place of ``mlp``, ``prenorm``, ``head`` empty when the
head is tied), so the bridge converts leaves and nothing else: q | k | v
stay in their split order along ``wqkv``'s wide axis and the tied head
keeps reading ``wte``. The JAX side is given as numpy arrays (``layers`` a
tuple); the port's side is fp32 tensors (``layers`` a list).

Not ported yet: HF interchange (``ckpt.load_format=hf``) and the elastic
resume of a checkpoint from another world size, which raises
:class:`WorldSizeMismatchError`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.observability.registry import get_registry
from hetu_galvatron_tpu_torch.runtime import ckpt_paths
from hetu_galvatron_tpu_torch.runtime.ckpt_paths import read_resume_pin
from hetu_galvatron_tpu_torch.runtime.optimizer import AdamState
from hetu_galvatron_tpu_torch.utils.retrying import retry_call

Params = Dict[str, Any]
Log = Callable[[str], None]

COMMIT_MARKER = ckpt_paths.COMMIT_MARKER
_TMP_SUFFIX = ckpt_paths.TMP_SUFFIX
_OLD_SUFFIX = ckpt_paths.OLD_SUFFIX
PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
# transient-I/O policy of every checkpoint read and write: attempts, and
# the total-elapsed watchdog of one retried call (a mount that hangs
# rather than erroring must not stall a resume for attempts x hang)
IO_ATTEMPTS = 3
IO_DEADLINE_S = 120.0

_step_of = ckpt_paths.step_of
is_committed = ckpt_paths.is_committed


def _print(msg: str) -> None:
    print(msg, flush=True)


def _count(name: str, **labels) -> None:
    get_registry().counter(f"checkpoint/{name}", **labels).inc()


def _gauge(name: str, value: float) -> None:
    get_registry().gauge(f"checkpoint/{name}").set(float(value))


def _retry(fn, op: str):
    return retry_call(fn, attempts=IO_ATTEMPTS, base=0.2, cap=5.0,
                      retryable=lambda e: isinstance(e, OSError), op=op,
                      deadline_s=IO_DEADLINE_S)


class WorldSizeMismatchError(ValueError):
    """The checkpoint's recorded world_size differs from the live world.

    Surfaces at load with both worlds named, instead of as a shape error
    inside the restore. The JAX package catches it to re-search a plan and
    reshard; that elastic path is not ported yet, so here it stops the
    run."""

    def __init__(self, ckpt_dir: str, stored_world: int, live_world: int,
                 stored_plan: Optional[Dict[str, Any]] = None):
        self.ckpt_dir = ckpt_dir
        self.stored_world = int(stored_world)
        self.live_world = int(live_world)
        self.stored_plan = stored_plan
        super().__init__(
            f"checkpoint {ckpt_dir} was committed by a "
            f"{stored_world}-device world but the live world has "
            f"{live_world} devices: its arrays are laid out for the old "
            "plan and will not restore here. Resuming under another world "
            "size needs a re-searched plan and a reshard (the elastic "
            "resume path), which is not ported to hetu_galvatron_tpu_torch "
            "yet.")


def _plan_fingerprint(hpc) -> Dict[str, Any]:
    """The JAX package's plan fingerprint: ``strategy_list2config`` of the
    per-layer and vocab strategies with ``pp_division`` (``pp_deg`` and
    ``pipeline_type`` ride in it), plus ``world_size``; ``vpp_deg`` joins
    when above 1."""
    from hetu_galvatron_tpu_torch.utils.strategy import strategy_list2config

    cfg = strategy_list2config(
        hpc.layers, global_bsz=hpc.global_bsz, chunks=hpc.chunks,
        pipeline_type=hpc.pipeline_type,
        default_dp_type=hpc.default_dp_type, vocab=hpc.vocab,
        pp_division=hpc.pp_division or None,
        num_encoder_layers=hpc.num_encoder_layers or None,
        vpp_deg=hpc.vpp_deg)
    cfg["world_size"] = hpc.world_size
    return cfg


def _layout(plan: Dict[str, Any], layout: str) -> Tuple:
    """What fixes the layout a checkpoint's leaves are named by: the
    plan's stages and the engine's layout of them (``layout``)."""
    return (int(plan.get("pp_deg", 1)), plan.get("pp_division"),
            int(plan.get("vpp_deg", 1)), layout)


class PlanMismatchError(ValueError):
    """``strict_plan`` resume found a different plan fingerprint in the
    checkpoint. Typed so the resilient resume loop can tell an operator
    error that reproduces on every candidate from per-checkpoint
    corruption it should fall back past."""


# -- payload encoding ---------------------------------------------------------


def _leaf_names(params: Params) -> List[str]:
    return [n for n, _ in named_leaves(params)]


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` with ``fn`` applied to every tensor (dicts, lists, tuples
    and :class:`AdamState` are walked; other leaves are kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, AdamState):
        return replace(tree, mu=[fn(t) for t in tree.mu],
                       nu=[fn(t) for t in tree.nu])
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _host(t: torch.Tensor) -> torch.Tensor:
    # a copy even for a CPU tensor: the caller's leaf is updated in place
    # by the next step, possibly while an async write still reads this one
    return t.detach().to("cpu", copy=True)


def _params_payload(params: Params) -> Dict[str, torch.Tensor]:
    return {n: _host(t) for n, t in named_leaves(params)}


def _adam_states(opt_state: Any, params: Params
                 ) -> List[Tuple[str, AdamState, List[str]]]:
    """(key prefix, state, leaf names) for each AdamW state: one for a
    model, one per stage for the pipeline engine's lists (``"<s>."``)."""
    if isinstance(opt_state, AdamState):
        return [("", opt_state, _leaf_names(params))]
    if (isinstance(opt_state, (list, tuple)) and opt_state
            and all(isinstance(o, AdamState) for o in opt_state)):
        return [(f"{s}.", o, _leaf_names(p))
                for s, (o, p) in enumerate(zip(opt_state, params))]
    return []


def _opt_payload(opt_state: Any, params: Params) -> Dict[str, Any]:
    states = _adam_states(opt_state, params)
    if not states:
        return {n: _host(t) for n, t in named_leaves(opt_state)}
    out: Dict[str, Any] = {}
    for pre, st, names in states:
        out.update({f"{pre}count": int(st.count), f"{pre}adam": list(st.adam),
                    f"{pre}sgd": list(st.sgd)})
        for j, i in enumerate(st.adam):
            out[f"{pre}mu.{names[i]}"] = _host(st.mu[j])
            out[f"{pre}nu.{names[i]}"] = _host(st.nu[j])
    return out


def _check_names(stored, want, what: str) -> None:
    if sorted(stored) != sorted(want):
        missing = sorted(set(want) - set(stored))
        extra = sorted(set(stored) - set(want))
        raise ValueError(f"{what}: leaves missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")


def _pairs(payload: Dict[str, Any], leaves: List[Tuple[str, torch.Tensor]],
           what: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(target, stored) for every leaf, each checked for its name, shape
    and dtype."""
    _check_names([k for k in payload if isinstance(payload[k],
                                                   torch.Tensor)],
                 [n for n, _ in leaves], what)
    out = []
    for n, t in leaves:
        src = payload[n]
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"{what} leaf {n}: stored {src.dtype} "
                             f"{tuple(src.shape)}, target {t.dtype} "
                             f"{tuple(t.shape)}")
        out.append((t, src))
    return out


def _opt_leaves(target: Any, params: Params
                ) -> List[Tuple[str, torch.Tensor]]:
    states = _adam_states(target, params)
    if not states:
        return list(named_leaves(target))
    out = []
    for pre, st, names in states:
        out += ([(f"{pre}mu.{names[i]}", t) for i, t in zip(st.adam, st.mu)]
                + [(f"{pre}nu.{names[i]}", t) for i, t in zip(st.adam,
                                                               st.nu)])
    return out


def _write_torch(path: str, obj: Any) -> int:
    """torch.save + fsync (the marker may only land over a durable
    payload); returns the bytes written."""
    def write():
        with open(path, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
    _retry(write, "checkpoint.write")
    return os.path.getsize(path)


def _read_torch(path: str) -> Dict[str, Any]:
    return _retry(lambda: torch.load(path, map_location="cpu",
                                     weights_only=True, mmap=True),
                  "checkpoint.restore")


# -- save ---------------------------------------------------------------------


class _Writer:
    """Writes one staged payload, inline or on a thread; ``wait_until_
    finished`` joins and re-raises the write's error."""

    def __init__(self, fn: Callable[[], None], background: bool):
        self._fn = fn
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if background:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ckpt-async-save")
            self._thread.start()
        else:
            self._run()

    def _run(self) -> None:
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on wait
            self._error = e

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error


@dataclass
class _PendingSave:
    """A save whose commit (marker + rename + retention GC) runs once its
    writers have finished."""

    ckptrs: List[Any]
    tmp_dir: str
    final_dir: str
    root: str
    keep_last: int = 0
    # hooks["before_commit"](tmp_dir) runs with the payload staged and the
    # marker not yet written — the window a kill-mid-save drill tears
    hooks: Dict[str, Callable[..., Any]] = field(default_factory=dict)


_PENDING: List[_PendingSave] = []


def _commit(tmp_dir: str, final_dir: str) -> None:
    """Publish a fully-written staging dir: marker first (fsynced), then
    the atomic rename onto the final step name."""
    marker = os.path.join(tmp_dir, COMMIT_MARKER)
    with open(marker, "w") as f:
        f.write("committed\n")
        f.flush()
        os.fsync(f.fileno())
    old = None
    if os.path.isdir(final_dir):
        # overwriting an existing step (a re-save after a rollback): keep
        # the previous payload selectable until the new one lands — rename
        # aside, replace, then delete, so a crash at any point in between
        # still leaves a committed dir (the .old name is never selected
        # and is GC'd as stale)
        old = final_dir + _OLD_SUFFIX
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(final_dir, old)
    os.replace(tmp_dir, final_dir)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _count("committed")


def save_checkpoint(
    path: str,
    step: int,
    params: Params,
    opt_state: Any = None,
    hpc=None,
    *,
    async_save: bool = False,
    train_state: Optional[Dict[str, Any]] = None,
    keep_last: int = 0,
    hooks: Optional[Dict[str, Callable[..., Any]]] = None,
) -> str:
    """Write step directory ``<path>/step_<n>``: ``params.pt``,
    ``opt_state.pt`` (when given) and ``meta.json`` with the plan
    fingerprint and ``train_state``.

    The write is atomic: everything lands in ``step_<n>.tmp`` and is
    renamed into place only once complete, so a crash mid-save can never
    produce a directory :func:`latest_checkpoint` would select. The host
    copy is taken before this returns; with ``async_save`` the files are
    written on a thread and committed by :func:`wait_for_checkpoints`.
    ``keep_last > 0`` prunes all but the newest N committed steps after
    this one commits. The gauges ``checkpoint/save_ms`` and
    ``checkpoint/save_bytes`` give the last write's time (host copy,
    files, fsync) and size."""
    t0 = time.perf_counter()
    ckpt_dir = os.path.abspath(os.path.join(path, f"step_{step}"))
    tmp_dir = ckpt_dir + _TMP_SUFFIX
    if os.path.isdir(tmp_dir):
        # stale staging dir from a crashed earlier attempt at this step
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    parts: List[Tuple[str, Callable[[], Dict[str, Any]]]] = [
        (PARAMS_FILE, lambda: _params_payload(params))]
    if opt_state is not None:
        parts.append((OPT_FILE, lambda: _opt_payload(opt_state, params)))
    if async_save:
        # the host copy is taken now; a synchronous save copies one file's
        # worth at a time, so the host holds at most the larger file
        parts = [(f, (lambda p=fn(): p)) for f, fn in parts]
    meta: Dict[str, Any] = {"step": step}
    if hpc is not None:
        meta["hybrid_parallel_config"] = _plan_fingerprint(hpc)
    if train_state is not None:
        meta["train_state"] = train_state

    def write() -> None:
        nbytes = 0
        while parts:
            fname, payload = parts.pop(0)
            nbytes += _write_torch(os.path.join(tmp_dir, fname), payload())
        ckpt_paths.atomic_write_json(os.path.join(tmp_dir, "meta.json"),
                                     meta)
        _gauge("save_ms", (time.perf_counter() - t0) * 1e3)
        _gauge("save_bytes", nbytes)

    _count("saved")
    pending = _PendingSave([_Writer(write, background=async_save)], tmp_dir,
                           ckpt_dir, os.path.abspath(path), keep_last,
                           dict(hooks or {}))
    if async_save:
        _PENDING.append(pending)
    else:
        _finish(pending)
    return ckpt_dir


def _finish(p: _PendingSave) -> None:
    # await EVERY writer even when an earlier one fails: an abandoned
    # background write would keep streaming into a staging dir a
    # restarted attempt is about to clean
    first_err: Optional[BaseException] = None
    for c in p.ckptrs:
        try:
            c.wait_until_finished()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    before_commit = p.hooks.get("before_commit")
    if before_commit is not None:
        # fully staged, not yet committed: the exact window a
        # kill-mid-save chaos drill tears (and a hung-save drill stalls)
        before_commit(p.tmp_dir)
    _commit(p.tmp_dir, p.final_dir)
    if p.keep_last > 0:
        gc_checkpoints(p.root, keep_last=p.keep_last)


def wait_for_checkpoints() -> None:
    """Block until every async save has committed. The queue drains
    completely even when one save fails (every writer is awaited) and
    the first error re-raises after the drain. Each entry is popped
    before finishing so its own final dir is not counted as in-flight by
    its retention GC."""
    first_err: Optional[BaseException] = None
    while _PENDING:
        p = _PENDING.pop(0)
        try:
            _finish(p)
        except BaseException as e:  # noqa: BLE001 — re-raised after drain
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _in_flight_dirs() -> set:
    return {p.tmp_dir for p in _PENDING} | {p.final_dir for p in _PENDING}


# The step dir a live resume just selected, per checkpoint root: retention
# pruning racing a concurrent resume must never delete it out from under
# the restore. latest_checkpoint() records its selection here; the NEXT
# selection on the same root releases the previous one. Process-local;
# the cross-process half is the RESUME_PIN lease (runtime/ckpt_paths.py).
_RESUME_PROTECTED: Dict[str, str] = {}


def _recover_orphaned_old(path: str) -> None:
    """Roll back a crash mid-overwrite: if ``step_<n>.old`` (the previous
    committed payload renamed aside by :func:`_commit`) exists without a
    ``step_<n>``, the crash hit between the two renames — restore the old
    payload so the step stays selectable."""
    for entry in os.listdir(path):
        if not entry.endswith(_OLD_SUFFIX):
            continue
        base = entry[:-len(_OLD_SUFFIX)]
        if _step_of(base) is None:
            continue
        full = os.path.join(path, entry)
        final = os.path.join(path, base)
        if not os.path.exists(final) and is_committed(full):
            try:
                os.replace(full, final)
                _count("old_recovered")
            except OSError:
                pass  # a concurrent reader raced the same rollback


def gc_checkpoints(path: str, *, keep_last: int = 0) -> List[str]:
    """Remove partial step dirs (crashed saves) and, with ``keep_last > 0``,
    all but the newest N committed steps. In-flight async saves, the live
    resume selection and a pinned (``RESUME_PIN``) dir are never touched.
    Returns the removed paths."""
    if not os.path.isdir(path):
        return []
    _recover_orphaned_old(path)
    busy = _in_flight_dirs()
    protected = {_RESUME_PROTECTED.get(os.path.abspath(path))}
    pinned = read_resume_pin(path)
    if pinned is not None:
        protected.add(os.path.abspath(pinned))
    protected.discard(None)
    removed: List[str] = []
    committed: List[tuple] = []
    for entry in sorted(os.listdir(path)):
        full = os.path.join(path, entry)
        if not os.path.isdir(full) or full in busy:
            continue
        step = _step_of(entry)
        if step is not None and is_committed(full):
            committed.append((step, full))
            continue
        # our own staging/partial/old dirs only — a stray step_x or
        # step_5.partial we did not create is skipped, never deleted
        stale_ours = step is not None or any(
            entry.endswith(suf) and _step_of(entry[:-len(suf)]) is not None
            for suf in (_TMP_SUFFIX, _OLD_SUFFIX))
        if stale_ours:
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
            _count("gc_removed", kind="partial")
    if keep_last > 0 and len(committed) > keep_last:
        committed.sort()
        for _, full in committed[:-keep_last]:
            if os.path.abspath(full) in protected:
                _count("gc_protected")
                continue
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
            _count("gc_removed", kind="retention")
    return removed


def latest_checkpoint(path: str) -> Optional[str]:
    """Newest COMMITTED step dir, or None. Stray ``step_*`` entries with a
    non-integer suffix are skipped instead of crashing resume, and
    uncommitted partial dirs from a mid-save crash are never selected."""
    if not os.path.isdir(path):
        return None
    _recover_orphaned_old(path)
    best_step, best = -1, None
    for entry in os.listdir(path):
        step = _step_of(entry)
        if step is None:
            continue
        full = os.path.join(path, entry)
        if not os.path.isdir(full) or not is_committed(full):
            _count("partial_skipped")
            continue
        if step > best_step:
            best_step, best = step, full
    root = os.path.abspath(path)
    if best is not None:
        # shield the selection from retention pruning until the next
        # selection on this root (see _RESUME_PROTECTED)
        _RESUME_PROTECTED[root] = os.path.abspath(best)
    else:
        _RESUME_PROTECTED.pop(root, None)
    return best


def read_checkpoint_meta(ckpt_dir: str) -> Dict[str, Any]:
    """The step dir's meta.json (step, plan fingerprint, train_state) —
    {} when absent. Reads retry transient I/O errors."""
    mp = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(mp):
        return {}

    def _read():
        with open(mp) as f:
            return json.load(f)

    return _retry(_read, "checkpoint.read_meta")


def try_read_checkpoint_meta(
        ckpt_dir: str) -> Tuple[Dict[str, Any], Optional[Exception]]:
    """:func:`read_checkpoint_meta` that never raises: ``(meta, None)``
    on success, ``({}, error)`` on a corrupt/truncated/unreadable
    meta.json."""
    try:
        return read_checkpoint_meta(ckpt_dir), None
    except Exception as e:  # noqa: BLE001 — defensive read by contract
        return {}, e


def committed_checkpoints(path: str) -> List[str]:
    """Every committed step dir under ``path``, NEWEST first — the
    candidate order for a resilient resume."""
    return [d for _, d in reversed(ckpt_paths.committed_steps(path))]


def load_latest_resilient(
    path: str,
    params_target: Params,
    opt_target: Any = None,
    hpc=None,
    *,
    strict_plan: bool = False,
    expected_world: Optional[int] = None,
    log: Log = _print,
) -> Optional[Tuple[Params, Any, int, str]]:
    """Restore from the newest READABLE committed checkpoint under
    ``path``: corruption (truncated/garbled meta.json, a missing payload
    file, a stray COMMITTED marker over no payload) falls back to the
    previous committed step with a warning (``checkpoint/corrupt_
    fallback``), never a traceback.

    Returns ``(params, opt_state, step, ckpt_dir)`` or None when no
    committed checkpoint exists. :class:`WorldSizeMismatchError` and
    :class:`PlanMismatchError` propagate: they reproduce on every
    candidate. If candidates exist but every one is unreadable, raises
    RuntimeError naming them — silently restarting a long run from
    scratch is worse than a loud stop."""
    candidates = committed_checkpoints(path)
    if not candidates:
        return None
    last_err: Optional[Exception] = None
    for ckdir in candidates:
        try:
            params, opt_state, step = load_checkpoint(
                ckdir, params_target, opt_target, hpc=hpc,
                strict_plan=strict_plan, expected_world=expected_world)
        except (WorldSizeMismatchError, PlanMismatchError):
            raise
        except Exception as e:  # noqa: BLE001 — corruption class varies
            last_err = e
            _count("corrupt_fallback")
            log(f"warning: checkpoint {ckdir} is unreadable "
                f"({type(e).__name__}: {e}); falling back to the "
                "previous committed step")
            continue
        _RESUME_PROTECTED[os.path.abspath(path)] = os.path.abspath(ckdir)
        return params, opt_state, step, ckdir
    raise RuntimeError(
        f"all {len(candidates)} committed checkpoint(s) under {path} are "
        f"unreadable (last error: {type(last_err).__name__}: {last_err}); "
        "refusing to silently restart from scratch")


def load_checkpoint(
    ckpt_dir: str,
    params_target: Params,
    opt_target: Any = None,
    hpc=None,
    *,
    strict_plan: bool = False,
    expected_world: Optional[int] = None,
):
    """Restore into the target tensors, in place, and return ``(params,
    opt_state, step)`` (the targets). ``strict_plan`` asserts the stored
    plan fingerprint equals ``hpc``'s; ``expected_world`` raises
    :class:`WorldSizeMismatchError` for a checkpoint of another world size.
    Every stored leaf is checked for its name, shape and dtype before the
    first copy, so a mismatched payload leaves the targets untouched. The
    gauges ``checkpoint/load_ms`` and ``checkpoint/load_bytes`` give the
    load's time and the bytes read."""
    t0 = time.perf_counter()
    ckpt_dir = os.path.abspath(ckpt_dir)
    meta = read_checkpoint_meta(ckpt_dir)
    if "step" not in meta:
        raise FileNotFoundError(
            f"{ckpt_dir} has no meta.json — not a committed checkpoint")
    if expected_world is not None:
        stored_plan = meta.get("hybrid_parallel_config") or {}
        sw = stored_plan.get("world_size")
        if sw is not None and int(sw) != int(expected_world):
            raise WorldSizeMismatchError(ckpt_dir, int(sw),
                                         int(expected_world), stored_plan)
    ppath = os.path.join(ckpt_dir, PARAMS_FILE)
    if not os.path.exists(ppath) and os.path.isdir(
            os.path.join(ckpt_dir, "params")):
        raise ValueError(
            f"{ckpt_dir} holds an orbax checkpoint of the JAX package; "
            "restore it there and cross it over with params_from_jax / "
            "opt_state_from_jax")
    payload = _read_torch(ppath)
    if hpc is not None:
        from hetu_galvatron_tpu_torch.runtime.reshard import layout_of_names

        stored = meta.get("hybrid_parallel_config")
        current = _plan_fingerprint(hpc)
        here = layout_of_names(_leaf_names(params_target))
        there = layout_of_names(payload)
        # another stage or engine layout names other leaves: no restore
        # can take it, strict or not (re-laying it out is the reshard's
        # work)
        if (strict_plan and stored != current) or (
                stored is not None
                and _layout(stored, there) != _layout(current, here)):
            raise PlanMismatchError(
                f"checkpoint plan mismatch:\nstored  {stored} ({there} "
                f"layout)\ncurrent {current} ({here} layout); "
                "runtime/reshard.resume_elastic moves a checkpoint between "
                "the layouts")
    pairs = _pairs(payload, list(named_leaves(params_target)), PARAMS_FILE)
    opath = os.path.join(ckpt_dir, OPT_FILE)
    opt_state, opt_read = None, False
    if opt_target is not None and os.path.exists(opath):
        opt_payload = _read_torch(opath)
        opt_read = True
        for pre, st, _ in _adam_states(opt_target, params_target):
            if (list(opt_payload.get(f"{pre}adam", ())) != list(st.adam)
                    or list(opt_payload.get(f"{pre}sgd", ()))
                    != list(st.sgd)):
                raise ValueError(f"{OPT_FILE}: the stored adam/sgd leaf "
                                 "partition differs from the model's")
        pairs += _pairs(opt_payload, _opt_leaves(opt_target, params_target),
                        OPT_FILE)
        opt_state = opt_target
    # every leaf checked above; only now touch the targets
    with torch.no_grad():
        for t, src in pairs:
            t.copy_(src)
    for pre, st, _ in _adam_states(opt_state, params_target):
        st.count = int(opt_payload[f"{pre}count"])
    nbytes = os.path.getsize(ppath) + (
        os.path.getsize(opath) if opt_read else 0)
    _gauge("load_ms", (time.perf_counter() - t0) * 1e3)
    _gauge("load_bytes", nbytes)
    return params_target, opt_state, meta["step"]


# -- async snapshot checkpointing ---------------------------------------------


@dataclass
class _Snapshot:
    """A copy of the model state taken on the step, queued for the
    background writer; ``ready`` is the CUDA event recorded on ``device``
    after the copy (None on the CPU, where the copy is done when it
    returns)."""

    step: int
    params: Any
    opt_state: Any
    train_state: Optional[Dict[str, Any]] = None
    ready: Optional[torch.cuda.Event] = None
    device: Optional[torch.device] = None


def _device_copy(tree: Any):
    """Clone every tensor of ``tree`` where it lies, on the current stream;
    returns the copy, and the event recorded after it with its device when
    any tensor is on the card (else None, None)."""
    on_card: List[torch.device] = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            on_card.append(t.device)
        return t.detach().clone()

    out = _map_tensors(tree, copy)
    if not on_card:
        return out, None, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(on_card[0]))
    return out, ready, on_card[0]


class AsyncCheckpointer:
    """Split saves: an on-step device snapshot plus a background commit.

    ``snapshot(step, params, opt_state)`` clones the state on the device
    (see the module docstring for why, and what it costs) and returns the
    host time that took in ms, the step's whole save cost, also the gauge
    ``checkpoint/snapshot_stall_ms``. One daemon writer thread waits on
    the snapshot's event, copies it to the host and writes it through
    :func:`save_checkpoint`'s atomic protocol.

    Single-writer overlap rule: the queue holds at most ONE pending
    snapshot — a new snapshot supersedes an unstarted write
    (``checkpoint/snapshot_superseded``), but never interrupts a STARTED
    write. A write running past ``save_timeout_s`` is declared hung by the
    watchdog (``checkpoint/hung_saves``) and :meth:`drain` stops waiting
    on it — the daemon thread cannot block process exit. Writer errors
    are latched and re-raised at the next ``snapshot()``/``drain()``."""

    def __init__(self, root: str, *, hpc=None, keep_last: int = 0,
                 save_timeout_s: float = 120.0,
                 hooks: Optional[Dict[str, Callable[..., Any]]] = None,
                 log: Log = _print):
        self.root = root
        self.hpc = hpc
        self.keep_last = keep_last
        self.save_timeout_s = float(save_timeout_s)
        self.hooks = dict(hooks or {})
        self._log = log
        self._cv = threading.Condition()
        self._queue: Optional[_Snapshot] = None
        self._inflight: Optional[_Snapshot] = None
        self._started_at: Optional[float] = None
        self._hung_step: Optional[int] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.last_commit: Optional[Dict[str, Any]] = None

    # -- on-step half -------------------------------------------------------

    def snapshot(self, step: int, params: Params, opt_state: Any = None,
                 *, train_state: Optional[Dict[str, Any]] = None) -> float:
        """Queue a device snapshot of the state at ``step``; returns the
        stall in ms."""
        self.check_watchdog()
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        t0 = time.perf_counter()
        (params_c, opt_c), ready, device = _device_copy((params, opt_state))
        stall_ms = (time.perf_counter() - t0) * 1e3
        _gauge("snapshot_stall_ms", stall_ms)
        _count("snapshots")
        snap = _Snapshot(step, params_c, opt_c, train_state, ready, device)
        with self._cv:
            if self._queue is not None:
                _count("snapshot_superseded")
                self._log(
                    f"checkpoint: snapshot at step {step} supersedes the "
                    f"unstarted write at step {self._queue.step}")
            self._queue = snap
            self._cv.notify_all()
        self._ensure_thread()
        return stall_ms

    # -- background half ----------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name="ckpt-writer")
            self._thread.start()

    def _write(self, snap: _Snapshot) -> None:
        save = lambda: save_checkpoint(  # noqa: E731
            self.root, snap.step, snap.params, snap.opt_state, hpc=self.hpc,
            train_state=snap.train_state, keep_last=self.keep_last,
            hooks=self.hooks)
        if snap.ready is None:
            save()
            return
        # the host copies run on a stream of the writer's own, after the
        # snapshot's copies and beside whatever the step enqueues next
        with torch.cuda.device(snap.device):
            stream = torch.cuda.Stream()
            stream.wait_event(snap.ready)
            with torch.cuda.stream(stream):
                save()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while self._queue is None and not self._closed:
                    self._cv.wait(timeout=0.2)
                if self._queue is None:
                    return  # closed and drained
                snap, self._queue = self._queue, None
                self._inflight = snap
                self._started_at = time.monotonic()
            try:
                before_write = self.hooks.get("before_write")
                if before_write is not None:
                    before_write(snap.step)
                self._write(snap)
                self.last_commit = {"step": snap.step,
                                    "t_wall": time.time()}
                _count("async_committed")
            except BaseException as e:  # noqa: BLE001 — latched for caller
                self.error = e
                _count("async_save_errors")
                try:
                    self._log("warning: async checkpoint write at step "
                              f"{snap.step} failed: {e}")
                except Exception:  # noqa: BLE001 — log must not kill worker
                    pass
            finally:
                with self._cv:
                    self._inflight = None
                    self._started_at = None
                    self._cv.notify_all()

    # -- watchdog / drain ---------------------------------------------------

    def check_watchdog(self) -> bool:
        """True when the in-flight write has exceeded ``save_timeout_s``
        (counted once per hung save as ``checkpoint/hung_saves``)."""
        with self._cv:
            started, inflight = self._started_at, self._inflight
        if (started is None or inflight is None
                or time.monotonic() - started <= self.save_timeout_s):
            return False
        if self._hung_step != inflight.step:
            self._hung_step = inflight.step
            _count("hung_saves")
            self._log(f"warning: checkpoint write at step {inflight.step} "
                      f"exceeded the {self.save_timeout_s:.1f}s watchdog "
                      "deadline; it will not be waited on")
        return True

    def pending(self) -> bool:
        with self._cv:
            return self._queue is not None or self._inflight is not None

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until queued + in-flight writes finish. Returns False
        (after declaring the save hung) instead of blocking forever when
        the writer exceeds the deadline; re-raises a latched writer
        error once drained."""
        if timeout_s is None:
            timeout_s = self.save_timeout_s
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._queue is not None or self._inflight is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 0.2))
            drained = self._queue is None and self._inflight is None
            inflight = self._inflight
        if not drained:
            self.check_watchdog()
            if self._hung_step is None:
                # not yet past the per-save watchdog, but the caller's
                # drain budget is spent — same give-up contract
                _count("hung_saves")
                self._hung_step = inflight.step if inflight else -1
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        return drained

    def close(self, timeout_s: Optional[float] = None) -> bool:
        drained = self.drain(timeout_s)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None and drained:
            self._thread.join(timeout=5.0)
        return drained


class CheckpointCadence:
    """One save policy for both cadences and both write modes.

    ``due(it)`` is true when the step cadence (``ckpt.save_interval``) OR
    the wall-clock cadence (``ckpt.interval_s``) has elapsed.
    ``save(step, ...)`` goes through the :class:`AsyncCheckpointer`
    snapshot path when ``ckpt.snapshot_async`` is set, else through
    :func:`save_checkpoint` (on a thread with ``ckpt.async_save``).
    With a ``goodput`` tracker (``observability/goodput.py``) the save
    books its stall to ``checkpoint_save``: the snapshot's dispatch stall
    for async snapshots (the write overlaps training; the caller books the
    final drain), the whole call otherwise (JAX :838-851)."""

    def __init__(self, ck, *, hpc=None, goodput=None, log: Log = _print,
                 hooks: Optional[Dict[str, Callable[..., Any]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.ck = ck
        self.hpc = hpc
        self.goodput = goodput
        self.hooks = dict(hooks or {})
        self._log = log
        self._clock = clock
        self._last_save_t = clock()
        self.async_ckptr: Optional[AsyncCheckpointer] = None
        if ck.save and ck.snapshot_async:
            self.async_ckptr = AsyncCheckpointer(
                ck.save, hpc=hpc, keep_last=ck.keep_last,
                save_timeout_s=ck.save_timeout_s, hooks=self.hooks, log=log)

    def due(self, it: int) -> bool:
        ck = self.ck
        if not ck.save:
            return False
        if ck.save_interval and (it + 1) % ck.save_interval == 0:
            return True
        if ck.interval_s and \
                self._clock() - self._last_save_t >= ck.interval_s:
            return True
        return False

    def save(self, step: int, params: Params, opt_state: Any = None,
             *, train_state: Optional[Dict[str, Any]] = None) -> None:
        self._last_save_t = self._clock()
        if self.async_ckptr is not None:
            stall_ms = self.async_ckptr.snapshot(
                step, params, opt_state, train_state=train_state)
            if self.goodput is not None:
                self.goodput.add("checkpoint_save", stall_ms / 1e3)
            return
        t0 = time.perf_counter()
        try:
            save_checkpoint(self.ck.save, step, params, opt_state,
                            hpc=self.hpc, async_save=self.ck.async_save,
                            train_state=train_state,
                            keep_last=self.ck.keep_last, hooks=self.hooks)
        finally:
            if self.goodput is not None:
                self.goodput.add("checkpoint_save",
                                 time.perf_counter() - t0)

    def drain(self) -> None:
        """Exit/preempt barrier: nothing in flight may outlive (or race)
        what follows — a synchronous exit save, or process exit. A hung
        async write is abandoned after its watchdog deadline rather than
        blocking shutdown."""
        if self.async_ckptr is not None:
            if not self.async_ckptr.drain():
                self._log("warning: abandoning a hung checkpoint write "
                          "at exit (see checkpoint/hung_saves)")
        wait_for_checkpoints()


# -- weight and optimizer-state bridge ----------------------------------------

_NORM = {"scale", "bias"}
_KEYS = {
    "embed": {"wte", "wpe", "ln"},
    "attn": {"wqkv", "bqkv", "wo", "bo"},
    "cross": {"wq", "bq", "wkv", "bkv", "wo", "bo"},
    "mlp": {"win", "bin", "wout", "bout"},
    "moe": {"router", "win", "wout", "shared", "expert_bias"},
    "head": {"whead", "wt", "bt", "ln", "bias"},
}


def _check_keys(tree: Dict, allowed, where: str) -> None:
    extra = set(tree) - set(allowed)
    if extra:
        raise ValueError(f"{where}: keys {sorted(extra)} are outside this "
                         "slice of the port, which reads the trees of the JAX "
                         "package's model zoo")


def _to_torch(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device,
                        requires_grad=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _map(tree: Dict, fn, where: str, allowed) -> Dict:
    """Leaves through ``fn``; a nested ``ln`` (BERT's embedding and MLM
    head norms) is a norm subtree."""
    _check_keys(tree, allowed, where)
    return {k: (_map(v, fn, f"{where}.{k}", _NORM) if k == "ln" else fn(v))
            for k, v in tree.items()}


def _convert(tree: Params, leaf, layers_type) -> Params:
    """Every tree of the JAX package's model zoo: decoder-only (dense or
    MoE layers), BERT's (an embedding LayerNorm, the MLM head, an empty
    ``prenorm``) and T5's (``enc_layers``, ``enc_norm``, and decoder layers
    with ``lnx`` and ``cross``)."""
    t5 = "enc_layers" in tree
    _check_keys(tree, {"embed", "layers", "prenorm", "head"}
                | ({"enc_layers", "enc_norm"} if t5 else set()), "params")

    def norm(t, where):
        return _map(t, leaf, where, _NORM)

    def moe(t, where):
        out = _map({k: v for k, v in t.items() if k != "shared"}, leaf,
                   where, _KEYS["moe"])
        if "shared" in t:
            out["shared"] = _map(t["shared"], leaf, f"{where}.shared",
                                 _KEYS["mlp"])
        return out

    def layer(lp, where, cross):
        ffn = "moe" if "moe" in lp else "mlp"
        blocks = {"ln1": norm, "ln2": norm, "lnx": norm,
                  "attn": lambda t, w: _map(t, leaf, w, _KEYS["attn"]),
                  "cross": lambda t, w: _map(t, leaf, w, _KEYS["cross"]),
                  "mlp": lambda t, w: _map(t, leaf, w, _KEYS["mlp"]),
                  "moe": moe}
        _check_keys(lp, {"ln1", "attn", "ln2", ffn}
                    | ({"lnx", "cross"} if cross else set()), where)
        return {k: blocks[k](v, f"{where}.{k}") for k, v in lp.items()}

    out = {
        "embed": _map(tree["embed"], leaf, "embed", _KEYS["embed"]),
        "layers": layers_type(layer(lp, f"layers[{i}]", t5)
                              for i, lp in enumerate(tree["layers"])),
        "prenorm": norm(tree.get("prenorm", {}), "prenorm"),
        "head": _map(tree.get("head", {}), leaf, "head", _KEYS["head"]),
    }
    if t5:
        out["enc_layers"] = layers_type(
            layer(lp, f"enc_layers[{j}]", False)
            for j, lp in enumerate(tree["enc_layers"]))
        out["enc_norm"] = norm(tree["enc_norm"], "enc_norm")
    return out


def params_from_jax(tree: Params, device="cpu") -> Params:
    """The JAX package's parameter tree (numpy leaves) -> the port's tree of
    fp32 tensors that require grad."""
    return _convert(tree, lambda x: _to_torch(x, device), list)


def params_to_jax(params: Params) -> Params:
    """The port's tree -> the JAX package's structure with numpy fp32
    leaves (``layers`` a tuple); inverse of :func:`params_from_jax`."""
    return _convert(params, _to_numpy, tuple)


def spmd_params_from_jax(tree: Params, engine, device="cpu") -> Params:
    """The JAX package's full parameter tree -> this rank's slices under a
    plan over ranks (``parallel/spmd.SpmdEngine.shard_params``)."""
    return engine.shard_params(params_from_jax(tree, device))


def spmd_params_to_jax(params: Params, engine) -> Params:
    """This rank's slices -> the JAX package's full tree (numpy), through
    ``SpmdEngine.gather_params``: a collective, every rank calls it."""
    return params_to_jax(engine.gather_params(params))


def _jax_named(tree: Any, prefix: str = ""):
    """(dotted name, leaf) over a JAX-side tree in ``named_leaves`` order:
    dict keys sorted, tuple and list entries by index; optax's
    ``MaskedNode`` (an empty NamedTuple at a leaf another partition owns)
    yields nothing."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_named(tree[k], f"{prefix}.{k}" if prefix
                                  else str(k))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _jax_named(v, f"{prefix}.{i}" if prefix else str(i))
    elif not hasattr(tree, "_fields"):
        yield prefix, tree


def _adam_node(state: Any):
    """The optax ``ScaleByAdamState`` (a NamedTuple with ``count``, ``mu``
    and ``nu``) inside a chain / partition state."""
    if hasattr(state, "_fields") and {"count", "mu", "nu"} <= set(
            state._fields):
        return state
    children = (state.values() if isinstance(state, dict) else
                state if isinstance(state, (list, tuple)) else ())
    for child in children:
        found = _adam_node(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(state: Any, params: Params,
                       device="cpu") -> AdamState:
    """The JAX optimizer's state (``make_optimizer``: ``partition_expert_
    bias`` over clip -> ``scale_by_adam`` -> decay -> lr, numpy or JAX
    leaves) -> the port's :class:`AdamState` for ``params`` (the port's
    tree, as ``params_from_jax`` gives it). ``mu`` / ``nu`` come from the
    ``ScaleByAdamState`` by leaf name; ``count`` is its update count (the
    schedule's count equals it); expert-bias leaves, which optax masks out
    of the Adam partition, take SGD with no state."""
    adam = _adam_node(state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the JAX "
                         "optimizer state")
    mu, nu = dict(_jax_named(adam.mu)), dict(_jax_named(adam.nu))
    names = _leaf_names(params)
    sgd = [i for i, n in enumerate(names) if n.endswith("expert_bias")]
    adam_idx = [i for i in range(len(names)) if i not in set(sgd)]
    _check_names(mu, [names[i] for i in adam_idx], "JAX mu")

    def leaf(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return AdamState(count=int(np.asarray(adam.count)), adam=adam_idx,
                     sgd=sgd, mu=[leaf(mu[names[i]]) for i in adam_idx],
                     nu=[leaf(nu[names[i]]) for i in adam_idx])


def opt_state_to_jax(state: AdamState, params: Params, like: Any) -> Any:
    """The port's :class:`AdamState` -> the JAX optimizer's state, built on
    ``like`` (the JAX ``tx.init`` of the same model, which fixes optax's
    node types without this package importing optax): every ``count`` of
    the chain becomes the update count and ``mu`` / ``nu`` take the port's
    moments by leaf name, as numpy fp32."""
    names = _leaf_names(params)
    by_name = {"mu": {names[i]: _to_numpy(t)
                      for i, t in zip(state.adam, state.mu)},
               "nu": {names[i]: _to_numpy(t)
                      for i, t in zip(state.adam, state.nu)}}
    count = np.asarray(state.count, dtype=np.int32)

    def moments(tree, table, prefix=""):
        if isinstance(tree, dict):
            return {k: moments(v, table, f"{prefix}.{k}" if prefix
                               else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
            return type(tree)(moments(v, table, f"{prefix}.{i}" if prefix
                                      else str(i))
                              for i, v in enumerate(tree))
        if hasattr(tree, "_fields"):
            return tree  # MaskedNode: another partition's leaf
        return table[prefix]

    def walk(node):
        if hasattr(node, "_fields"):
            fields_ = set(node._fields)
            upd = {}
            if {"mu", "nu"} <= fields_:
                upd = {"mu": moments(node.mu, by_name["mu"]),
                       "nu": moments(node.nu, by_name["nu"])}
            if "count" in fields_:
                upd["count"] = count
            rest = {f: walk(getattr(node, f)) for f in node._fields
                    if f not in upd}
            return node._replace(**upd, **rest)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(like)
