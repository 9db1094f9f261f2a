"""Fault tolerance: checkpoint/restore, leader election, replica failover.

The PyTorch port of the JAX package's ``distributed/fault_tolerance.py``.
The on-disk format is the JAX package's (``MANIFEST.json`` fields,
``arrays.npz`` with ``leaf_{i}`` / ``leaf_{i}_idx`` / ``leaf_{i}_val``,
0-d leaves always whole, u32 lanes stored as ``uint32``), so a snapshot
written by either package restores in the other. Differences, all
deliberate:

  * ``save`` takes a list of leaves (the engine's ``_flat_leaves`` order,
    which is ``jax.tree.flatten``'s) or a dict (flattened by sorted key, as
    ``jax.tree.flatten`` flattens one), each leaf a torch tensor on any
    device or a numpy array, instead of a pytree. Every leaf is copied to
    host memory the manager owns, so the delta shadow never aliases a
    tensor the caller goes on mutating in place (the port's stores do).
    A tensor viewed as ``torch.uint32`` is stored as ``uint32``;
  * npz cannot hold bfloat16, so a bfloat16 leaf (a tensor, or a numpy
    array of ``ml_dtypes``' bfloat16) is stored as its bits, a ``uint16``
    view, with ``raw_dtypes["leaf_<i>"] = "bfloat16"`` in the manifest, as
    the JAX package stores one, and restored as bfloat16 by that name with
    ``torch`` views alone (no ``ml_dtypes``). Any other dtype npz cannot
    store (float8, torch's ``uint16``/``uint64``) is refused with a
    ``ValueError``, and so is a manifest naming another raw dtype;
  * every save is zlib-compressed (``SNAPSHOT_CODEC``) and stale ``.tmp_*``
    dirs expire after ``TMP_TTL_S``; restore decodes any codec, so the JAX
    package's ``codec="raw"`` snapshots restore too;
  * ``last_save_ms`` / ``last_restore_ms`` hold the last save's and
    restore's cost split (host copy, dirty-row diff, npz, zlib, digests,
    write and fsync; read, decode, delta apply, device copy).

Mirrors the paper's §4.2 persistence design: "the [replicated] instances
perform leader election using ZooKeeper, and the winner proceeds to write
its results" every five minutes; frontends poll for updated results; on a
cold restart they serve the most-recently persisted state immediately.

Implementation: atomic-rename checkpoints (npz payload + json manifest),
keep-N retention, deterministic leader election over live replica ids (the
ZooKeeper-less equivalent: lowest live id wins — same liveness semantics,
suitable for the single-writer persistence pattern), and crash-recovery
restore into a template's dtypes and devices.

**Incremental (delta) snapshots** — the snapshot-chain format. A snapshot
step is either a *full* checkpoint (every leaf written whole) or a *delta*
against the immediately preceding snapshot (changed leading slots only —
MillWheel-style low-watermark checkpointing over the stores' known-dirty
slots; see ``core.stores.diff_leading_rows``). One manifest per step dir:

    MANIFEST.json = {
      "step":      int,
      "kind":      "full" | "delta",
      "base_step": int | null,   # delta only: the previous snapshot in the
                                 # chain (full or delta) it was diffed against
      "n_leaves":  int,          # leaf count (layout-mismatch guard)
      "raw_dtypes": {...},       # bfloat16 leaves, stored as uint16 bits
      "sha256":    hex,          # over the arrays.npz bytes (torn/corrupt
                                 # detection during the chain walk)
      "nbytes":    int,          # arrays.npz size (delta-vs-full accounting)
      "time":      float, "meta": {...},
    }

arrays.npz holds ``leaf_{i}`` whole for a full (and for 0-d leaves always);
a delta stores ``leaf_{i}_idx`` (changed leading indices, i64) +
``leaf_{i}_val`` (the rows at those indices) per array leaf. Both full and
delta payloads are wrapped in a ``streaming.codec`` compressed container
(manifest ``codec``/``raw_sha256``/``raw_nbytes``; ``sha256``/``nbytes``
stay over the on-disk bytes so torn-write detection and the
``corrupt_snapshot`` injector are codec-oblivious); pre-codec raw-npz
checkpoints restore transparently.

Restore **chain-walk**: resolve the requested step back through
``base_step`` links to its base full (verifying each member's sha256), then
apply the deltas oldest-first onto the full's arrays. **Fallback rule**: a
torn/corrupt/missing chain member falls back to the newest *intact full*
snapshot at ``step <= requested`` — the caller observes an older restored
step and simply replays a longer firehose-log tail (``streaming.replay``
handles this transparently); only when no full verifies does restore raise.
**Retention rule**: the newest ``keep_n`` steps are kept, *expanded* by
every chain base a kept delta references — a full is never unlinked while a
retained delta still needs it, and a delta is never retained without its
base chain.

``full_interval=1`` (the default) disables deltas entirely — every save is
a full checkpoint, byte-identical behavior to the pre-delta manager. With
``full_interval=F``, each full is followed by up to ``F-1`` deltas. The
delta diff runs against an in-memory shadow of the last-saved leaves, so a
freshly constructed manager (e.g. after a process restart) always writes a
full first.

The manager is layout-agnostic: it sees a list of leaves, whatever the
engine's cooc layout.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.stores import apply_row_delta, diff_leading_rows


def _codec():
    # Lazy: ``streaming.replay`` imports this module at its top level, so a
    # top-level import of ``streaming.codec`` here would make the package
    # import order circular. By first call, both packages are initialized.
    from ..streaming import codec as c
    return c


# Payload codec of every save (``streaming.codec``), and the age past which
# a ``.tmp_*`` dir is a crashed writer's debris that retention removes.
SNAPSHOT_CODEC = "zlib"
TMP_TTL_S = 3600.0

Leaves = Union[List[Any], Tuple[Any, ...], Dict[str, Any]]


def _flatten(tree: Leaves) -> List[Any]:
    """A list or tuple of leaves as given; a dict by sorted key."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _unflatten(tree: Leaves, leaves: List[Any]) -> Leaves:
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), leaves))
    return type(tree)(leaves)


BF16 = "bfloat16"    # the one raw-viewed dtype: stored as its uint16 bits


def _to_host(x) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of ``x`` that nothing else references, and the raw
    dtype it views (``"bfloat16"``, stored as ``uint16`` bits) or None. A
    ``torch.uint32`` tensor comes back as ``uint32`` (copied through its
    int32 view, which every torch build's copy kernels take)."""
    if not isinstance(x, torch.Tensor):
        a = np.array(x, copy=True)
        if a.dtype.name == BF16:
            return a.view(np.uint16), BF16
        if a.dtype.kind == "V":
            raise ValueError(f"cannot snapshot numpy dtype {a.dtype}")
        return a, None
    t = x.detach()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to("cpu", copy=True).numpy().view(
            np.uint32), None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16), BF16
    if t.dtype in (torch.uint16, torch.uint64) or t.dtype.is_floating_point \
            and t.element_size() == 1:
        raise ValueError(f"cannot snapshot a {t.dtype} leaf: npz cannot "
                         f"store it")
    return t.to("cpu", copy=True).numpy(), None


def _from_raw(a: np.ndarray, raw: Optional[str]):
    """A stored array as the dtype it was saved from: a bfloat16 leaf's
    uint16 bits as a bfloat16 tensor."""
    if raw is None:
        return a
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def _to_leaf(a, leaf):
    """A restored array (or bfloat16 tensor) in the dtype and on the device
    of template ``leaf``."""
    if isinstance(a, torch.Tensor):
        if not isinstance(leaf, torch.Tensor):
            return a.float().numpy().astype(leaf.dtype)
        return a.to(device=leaf.device, dtype=leaf.dtype)
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(a, dtype=leaf.dtype)
    if leaf.dtype == torch.uint32:
        a = np.asarray(a, np.uint32, order="C")
        return torch.from_numpy(a.view(np.int32)).to(leaf.device).view(
            torch.uint32)
    # np.asarray keeps a 0-d leaf 0-d (np.ascontiguousarray would not)
    return torch.from_numpy(np.asarray(a, order="C")).to(device=leaf.device,
                                                         dtype=leaf.dtype)


def _sync(leaves) -> None:
    """Wait for device copies to land (a timing boundary)."""
    devs = {x.device for x in leaves if isinstance(x, torch.Tensor)
            and x.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 full_interval: int = 1):
        if full_interval < 1:
            raise ValueError(f"full_interval must be >= 1, not "
                             f"{full_interval}")
        self.dir = directory
        self.keep_n = keep_n
        # delta-snapshot chain: every ``full_interval``-th save is a full,
        # the rest are deltas against the previous save (1 = fulls only).
        self.full_interval = full_interval
        self._shadow: Optional[List[np.ndarray]] = None  # last-saved leaves
        self._shadow_step: Optional[int] = None
        self._since_full = 0
        self.last_save_kind: Optional[str] = None
        self.last_save_bytes = 0
        self.last_save_raw_bytes = 0    # the npz body inside the container
        # the last save's and restore's cost split, ms by step
        self.last_save_ms: Dict[str, float] = {}
        self.last_restore_ms: Dict[str, float] = {}
        # last restore's provenance: {requested, restored, chain_len,
        # fell_back} — ``fell_back`` means a torn/corrupt chain member was
        # skipped and an older intact full was used instead.
        self.last_restore: Dict[str, Any] = {}
        os.makedirs(directory, exist_ok=True)

    # -- paths --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: Optional[int] = None) -> Dict:
        """The manifest of a checkpoint (its ``meta`` carries the log
        offset for §4.2-style catch-up recovery)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    # -- save/restore --
    def save(self, step: int, tree: Leaves,
             meta: Optional[Dict] = None) -> str:
        """Atomic: write into a tmp dir, fsync, rename into place.

        ``tree`` is a list of leaves (or a dict, by sorted key): torch
        tensors on any device or numpy arrays, each copied to host memory
        the manager owns. With ``full_interval > 1`` the manager writes
        *delta* snapshots (changed leading slots only, diffed against the
        in-memory shadow of the previous save) between fulls — see the
        module docstring for the chain format. The decision is internal:
        callers keep calling ``save`` and the manifest records what was
        written.
        """
        times: Dict[str, float] = {}
        t0 = time.perf_counter()
        hosted = [_to_host(x) for x in _flatten(tree)]
        np_leaves = [a for a, _ in hosted]
        raw = {f"leaf_{i}": r for i, (_, r) in enumerate(hosted) if r}
        times["to_host"] = time.perf_counter() - t0
        kind, base_step = "full", None
        if (self.full_interval > 1 and self._shadow is not None
                and self._shadow_step is not None
                and step > self._shadow_step
                and self._since_full < self.full_interval - 1
                and len(np_leaves) == len(self._shadow)
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(np_leaves, self._shadow))):
            kind, base_step = "delta", self._shadow_step
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            arrays: Dict[str, np.ndarray] = {}
            t0 = time.perf_counter()
            for i, a in enumerate(np_leaves):
                if kind == "delta" and a.ndim >= 1:
                    idx = diff_leading_rows(self._shadow[i], a)
                    arrays[f"leaf_{i}_idx"] = idx
                    arrays[f"leaf_{i}_val"] = a[idx]
                else:   # full leaf; 0-d leaves are always written whole
                    arrays[f"leaf_{i}"] = a
            times["diff"] = time.perf_counter() - t0
            blob, cinfo = _codec().encode_payload(
                arrays, codec=SNAPSHOT_CODEC, fp_lanes=(), times=times)
            t0 = time.perf_counter()
            digest = hashlib.sha256(blob).hexdigest()
            times["sha256"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            manifest = {
                "step": step,
                "kind": kind,
                "base_step": base_step,
                "n_leaves": len(np_leaves),
                "raw_dtypes": raw,
                "sha256": digest,
                "nbytes": len(blob),
                "codec": cinfo["codec"],
                "raw_sha256": cinfo.get("raw_sha256"),
                "raw_nbytes": cinfo.get("raw_nbytes"),
                "time": time.time(),
                "meta": meta or {},
            }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            times["write_fsync"] = time.perf_counter() - t0
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # the host copies are the manager's own, so the shadow holds the
        # as-saved content whatever the caller mutates in place later.
        self._shadow = np_leaves
        self._shadow_step = step
        self._since_full = 0 if kind == "full" else self._since_full + 1
        self.last_save_kind, self.last_save_bytes = kind, len(blob)
        self.last_save_raw_bytes = cinfo.get("raw_nbytes") or len(blob)
        self.last_save_ms = {k: v * 1e3 for k, v in times.items()}
        self._gc()
        return self._step_dir(step)

    # -- chain-walk loading --
    def _verified_arrays(self, step: int, manifest: Dict,
                         times: Optional[Dict[str, float]] = None
                         ) -> Optional[Dict[str, np.ndarray]]:
        """Load + sha256-verify one step's arrays.npz; None when torn.
        ``times`` collects the seconds of each step."""
        path = os.path.join(self._step_dir(step), "arrays.npz")
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        t1 = time.perf_counter()
        want = manifest.get("sha256")
        ok = want is None or hashlib.sha256(blob).hexdigest() == want
        t2 = time.perf_counter()
        if times is not None:
            times["read"] = times.get("read", 0.0) + t1 - t0
            times["sha256"] = times.get("sha256", 0.0) + t2 - t1
        if not ok:
            return None
        try:
            # decodes compressed containers and legacy raw npz alike; a
            # CodecError (torn container / failed raw_sha256) means torn
            payload, _info = _codec().decode_payload(blob, times=times)
            return payload
        except Exception:   # noqa: BLE001 — short/garbled blob
            return None

    def _collect_chain(self, step: int, times: Optional[Dict] = None
                       ) -> Optional[List[Tuple[int, Dict, Dict]]]:
        """Walk ``step`` back to its base full, verifying every member.
        Returns [(step, manifest, arrays), ...] full-first, or None the
        moment any link is missing/torn/corrupt (caller falls back)."""
        chain: List[Tuple[int, Dict, Dict]] = []
        s: Optional[int] = step
        seen = set()
        while True:
            if s is None or s in seen:
                return None        # dangling or cyclic base pointer
            seen.add(s)
            try:
                man = self.manifest(s)
            except (OSError, json.JSONDecodeError):
                return None
            arrs = self._verified_arrays(s, man, times)
            if arrs is None:
                return None
            chain.append((s, man, arrs))
            if man.get("kind", "full") == "full":
                chain.reverse()
                return chain
            s = man.get("base_step")

    def load_arrays(self, step: Optional[int] = None,
                    times: Optional[Dict[str, float]] = None
                    ) -> Tuple[Dict[str, np.ndarray], Dict, int]:
        """Chain-walk load with torn/corrupt-delta fallback.

        Returns ``(arrays, manifest, restored_step)`` where ``arrays`` is
        the composed ``leaf_{i}`` dict (full + deltas applied oldest-first)
        and ``manifest`` belongs to ``restored_step``. When the requested
        step's chain is broken, falls back to the newest *intact full* at
        ``step <= requested`` (recorded in ``self.last_restore``); raises
        ``FileNotFoundError`` only when nothing verifies. ``times``
        collects the seconds of each step.
        """
        requested = step if step is not None else self.latest_step()
        if requested is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        self.last_restore = {"requested": requested, "restored": None,
                             "chain_len": 0, "fell_back": False}
        chain = self._collect_chain(requested, times)
        if chain is None:
            # fallback: newest verifiable full at or before the request.
            self.last_restore["fell_back"] = True
            for s in reversed([x for x in self.steps() if x <= requested]):
                try:
                    man = self.manifest(s)
                except (OSError, json.JSONDecodeError):
                    continue
                if man.get("kind", "full") != "full":
                    continue
                arrs = self._verified_arrays(s, man, times)
                if arrs is not None:
                    chain = [(s, man, arrs)]
                    break
            if chain is None:
                raise FileNotFoundError(
                    f"snapshot chain for step {requested} is torn and no "
                    f"intact full snapshot <= {requested} exists in "
                    f"{self.dir}")
        base_step, base_man, arrays = chain[0]
        n_leaves = base_man.get("n_leaves", 0)
        t0 = time.perf_counter()
        for s, man, delta in chain[1:]:
            for i in range(n_leaves):
                if f"leaf_{i}" in delta:      # 0-d / whole-leaf record
                    arrays[f"leaf_{i}"] = delta[f"leaf_{i}"]
                else:
                    arrays[f"leaf_{i}"] = apply_row_delta(
                        arrays[f"leaf_{i}"], delta[f"leaf_{i}_idx"],
                        delta[f"leaf_{i}_val"])
        if times is not None:
            times["delta_apply"] = time.perf_counter() - t0
        top_step, top_man, _ = chain[-1]
        self.last_restore.update({"restored": top_step,
                                  "chain_len": len(chain)})
        return arrays, top_man, top_step

    def restore_host(self, step: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """The composed ``leaf_{i}`` arrays of ``step`` (default: the
        newest), on the host, with the chain walk's fallback of
        :meth:`load_arrays`; no template and no device copy."""
        arrays, _, _ = self.load_arrays(step)
        return arrays

    def restore(self, template: Leaves, step: Optional[int] = None
                ) -> Tuple[Leaves, int]:
        """Restore into the dtype and device of each leaf of ``template``
        (a list or dict as ``save`` takes; numpy leaves come back as
        numpy arrays).

        Walks the delta chain (see ``load_arrays``); the returned step is
        the *actually restored* one — older than requested when a torn or
        corrupt chain member forced the fallback to the newest intact full
        (the caller then replays a longer log tail).
        """
        times: Dict[str, float] = {}
        arrays, manifest, step = self.load_arrays(step, times)
        raw = manifest.get("raw_dtypes") or {}
        other = {k: v for k, v in raw.items() if v != BF16}
        if other:
            raise ValueError(
                f"checkpoint step {step} holds raw-viewed leaves {other}, "
                f"which the port cannot restore (only {BF16})")
        leaves = _flatten(template)
        n_saved = manifest.get("n_leaves", len(leaves))
        if n_saved != len(leaves):
            raise ValueError(
                f"checkpoint step {step} holds {n_saved} leaves but the "
                f"restore template has {len(leaves)} — engine config / "
                f"store layout mismatch (e.g. hash vs region cooc)?")
        t0 = time.perf_counter()
        new = [_to_leaf(_from_raw(arrays[f"leaf_{i}"], raw.get(f"leaf_{i}")),
                        leaf) for i, leaf in enumerate(leaves)]
        _sync(new)
        times["to_device"] = time.perf_counter() - t0
        self.last_restore_ms = {k: v * 1e3 for k, v in times.items()}
        return _unflatten(template, new), step

    def _gc(self) -> None:
        steps = self.steps()
        keep = set(steps) if self.keep_n <= 0 else set(steps[-self.keep_n:])
        # chain protection: a kept delta pins its whole base chain — a full
        # is never unlinked while a retained delta still references it.
        for s in list(keep):
            cur = s
            for _ in range(len(steps) + 1):
                try:
                    man = self.manifest(cur)
                except (OSError, json.JSONDecodeError):
                    break
                if man.get("kind", "full") == "full":
                    break
                base = man.get("base_step")
                if base is None or base == cur:
                    break
                keep.add(base)
                cur = base
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # stale ``.tmp_*`` dirs left by crashed writers: a successful save
        # renames its tmp dir away, a failed one rmtree's it — anything
        # still here past the TTL belongs to a dead process.
        now = time.time()
        for name in os.listdir(self.dir):
            if not name.startswith(".tmp"):
                continue
            path = os.path.join(self.dir, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age >= TMP_TTL_S:
                shutil.rmtree(path, ignore_errors=True)


def corrupt_snapshot(ckpt: CheckpointManager, step: int,
                     keep_fraction: float = 0.5) -> None:
    """Failure injection: truncate a snapshot's ``arrays.npz`` in place (a
    torn write on a non-atomic filesystem). The chain walk's sha256 pass
    must reject it and fall back to the newest intact full snapshot."""
    path = os.path.join(ckpt._step_dir(step), "arrays.npz")
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: max(1, int(len(blob) * keep_fraction))])


# ---------------------------------------------------------------------------
# Leader election + replica group (paper §4.2 persistence pattern)
# ---------------------------------------------------------------------------

def elect_leader(live_replicas: Iterable[int]) -> Optional[int]:
    """Deterministic single-writer election: lowest live replica id."""
    live = sorted(live_replicas)
    return live[0] if live else None


class ReplicaGroup:
    """Replicated backend instances with single-writer persistence.

    Every replica holds the full engine state (the paper's replicated-not-
    sharded backend); each persistence cycle, the elected leader writes.
    ``fail``/``recover`` drive failure injection in tests; a recovered
    replica cold-starts from the latest checkpoint (paper: "upon a cold
    restart, the frontend caches can serve the most recently persisted
    results immediately").
    """

    def __init__(self, n_replicas: int, ckpt: CheckpointManager):
        self.alive = {i: True for i in range(n_replicas)}
        self.ckpt = ckpt
        # leadership epoch: bumped on EVERY leadership change (fail of the
        # leader, or a lower-id replica rejoining and re-winning the
        # deterministic election). The fencing token for the shared log:
        # the winner stamps it into the log manifest
        # (``FirehoseLogWriter.assume_epoch``) before its first append, so
        # a zombie ex-leader's stray appends are rejected.
        self.epoch = 0
        self._last_leader = self.leader()

    def live(self) -> List[int]:
        return [i for i, ok in self.alive.items() if ok]

    def leader(self) -> Optional[int]:
        return elect_leader(self.live())

    def _note_leadership(self) -> Optional[int]:
        lead = self.leader()
        if lead != self._last_leader:
            self.epoch += 1
            self._last_leader = lead
        return lead

    def fail(self, rid: int) -> None:
        self.alive[rid] = False
        self._note_leadership()

    def recover(self, rid: int) -> Optional[int]:
        """Rejoin; returns the checkpoint step to cold-start from.

        Rejoining may retake leadership (lowest live id wins) — that too is
        a leadership change and bumps the epoch, so the previous leader's
        writer is fenced the moment the rejoiner stamps the manifest."""
        self.alive[rid] = True
        self._note_leadership()
        return self.ckpt.latest_step()

    def persist(self, rid: int, step: int, tree: Any,
                meta: Optional[Dict] = None) -> bool:
        """Only the leader's write goes through (single-writer)."""
        if rid != self.leader():
            return False
        self.ckpt.save(step, tree, meta)
        return True

    def log_append(self, rid: int, writer: Any, *args, **kwargs) -> bool:
        """Leader-elected single WRITER for the durable firehose log.

        Every replica consumes the hoses (paper §4.2: replicated, not
        sharded), but only the elected leader appends to the shared durable
        log — the same single-writer pattern as ``persist``. Non-leader
        appends are dropped (return False); on failover the new leader's
        appends continue the log seamlessly because ticks, not writers,
        define the offset space, and a (possibly long-standby) writer
        re-syncs its manifest view at every segment start.

        Election alone cannot stop a partitioned/paused ex-leader that
        still believes it leads — that is what the epoch fence is for: the
        new leader calls ``writer.assume_epoch(group.epoch)`` before its
        first append, and the zombie's next append/flush raises
        ``streaming.log.WriterFencedError``.
        """
        if rid != self.leader():
            return False
        writer.append(*args, **kwargs)
        return True

