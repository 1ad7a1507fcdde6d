"""Persistent, content-addressed analysis store — cross-process memoization.

Twin of ``repro/dse/store.py``.  The in-memory
:class:`~repro_torch.dse.engine.AnalysisCache` makes one *engine* cheap;
this module makes repeated *invocations* cheap.  An :class:`AnalysisStore`
persists the two expensive sweep layers on disk:

  Layer 1 — the traced program as a compressed ``.npz`` column archive
  (one numpy array per I-state column, the reference's encoding — see
  :meth:`repro_torch.core.columnar.ColumnarTrace.to_arrays` — plus cache
  counters and program outputs) and a sibling flow-table archive, keyed by
  ``(workload fingerprint, cache geometry, trace-VM version)``.
  Layer 2 — accepted candidates + the reshaped trace (zlib-compressed
  pickle), keyed by the layer-1 key plus the full
  :class:`~repro_torch.core.offload.OffloadConfig`.

Two differences from the reference:

  * **Namespace.**  Every key spec and file name carries
    :data:`NAMESPACE` where the reference's carry ``cim``, so one directory
    shared by both packages never serves one package's artifact to the
    other (the ``FORMAT.json`` marker is shared: both read
    ``STORE_FORMAT`` 2).
  * **Devices.**  Artifacts hold numpy arrays on disk (the port's
    :class:`~repro_torch.core.idg.FlowIndex`, ``OffloadResult`` and
    ``ReshapedTrace`` pickle their tensors as numpy), and a load places
    them on the device the caller names.

:func:`workload_fingerprint` hashes the port's workload module, as the
reference hashes its own, so a persisted analysis goes stale when its
program changes.

The generic backend blobs (:meth:`AnalysisStore.load_blob` /
:meth:`~AnalysisStore.save_blob`) persist what a backend builds outside
the two CiM layers -- today the sampled pipeline's geometry-independent
artifact -- under a key spec the caller owns, in the same namespace.

Durability rules, as in the reference:

  * writes are atomic (temp file + ``os.replace``), so a concurrent reader
    never sees a partial artifact and concurrent writers of one key settle
    on one complete file;
  * loads verify a format stamp and the embedded key; anything unreadable
    or stale is dropped (counted in ``corrupt_drops``) and treated as a
    miss — the caller rebuilds and overwrites;
  * artifacts are self-contained: layer 1 rehydrates a full
    :class:`~repro_torch.core.trace.TraceResult` (including the structural
    trace other geometries can replay) from the columns alone, layer 2 a
    ``(OffloadResult, ReshapedTrace)`` pair (see
    :func:`~repro_torch.core.offload.rehydrate_analysis`).
"""
from __future__ import annotations

import hashlib
import inspect
import io
import json
import os
import pathlib
import pickle
import tempfile
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cache import CacheConfig, CacheHierarchy
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.idg import FlowIndex
from repro_torch.core.offload import (ANALYSIS_VERSION, OffloadConfig,
                                      OffloadResult)
from repro_torch.core.reshape import ReshapedTrace
from repro_torch.core.trace import (TRACE_VM_VERSION, StructuralTrace,
                                    TraceResult)

# Bump when the on-disk envelope (zlib-compressed {format, key, payload}
# pickle) changes.  v2: envelopes are compressed.
STORE_FORMAT = 2
# Bump when the layer-1 .npz column encoding changes.
NPZ_FORMAT = 1
#: the port's artifact namespace: key specs and file names (the reference's
#: CiM artifacts carry "cim")
NAMESPACE = "cimtorch"


def _fsize(path: pathlib.Path) -> int:
    """On-disk size for span attribution; 0 when absent/unreadable."""
    try:
        return path.stat().st_size
    except OSError:
        return 0


class StoreFormatError(RuntimeError):
    """The cache directory was written by a *newer* ``STORE_FORMAT``.

    Older artifacts under a new reader are individually dropped by the
    per-file format stamp; a newer directory under an old reader would be
    silently treated as 100% misses and then *overwritten*, destroying
    the newer build's cache — so that case refuses to open instead."""


_FINGERPRINTS: Dict[str, str] = {}


def workload_fingerprint(workload: str) -> str:
    """Content hash of a workload: its name + the builder module's source.

    Editing any code in the module that defines the workload's program
    invalidates every persisted analysis of it.  Unknown workloads (or
    unreadable source) degrade to a name-only fingerprint."""
    cached = _FINGERPRINTS.get(workload)
    if cached is not None:
        return cached
    src = ""
    try:
        from repro_torch.workloads import WORKLOADS
        builder = WORKLOADS.get(workload)
        if builder is not None:
            src = inspect.getsource(inspect.getmodule(builder))
    except (OSError, TypeError):
        src = ""
    digest = hashlib.sha256(f"{workload}\n{src}".encode()).hexdigest()[:16]
    _FINGERPRINTS[workload] = digest
    return digest


def _cache_geometry(levels: Sequence[CacheConfig]) -> list:
    """Full per-level geometry — two configs with equal sizes but different
    associativity/banking must never share an artifact."""
    return [[c.name, c.size, c.assoc, c.banks, c.mshrs] for c in levels]


def _offload_spec(cfg: OffloadConfig) -> dict:
    return {
        "cim_set": sorted(cfg.cim_set),
        "cim_levels": list(cfg.cim_levels),
        "require_same_bank": cfg.require_same_bank,
        "allow_cross_level": cfg.allow_cross_level,
        "min_mem_operands": cfg.min_mem_operands,
        "min_load_leaves": cfg.min_load_leaves,
        "max_tree_ops": cfg.max_tree_ops,
    }


def _publish(path: pathlib.Path, data: bytes) -> None:
    """Atomic publish: readers see the old file or the new one, never bytes
    in between; racing writers settle on a complete file."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class AnalysisStore:
    """Content-addressed on-disk artifact store (one directory tree).

    ``version`` defaults to the trace VM's version; passing an explicit
    value exists for tests and for pinning a store to an older VM.
    Hit/miss/write/corruption counters mirror the in-memory cache's build
    counters so sweeps can *prove* a warm second run did no analysis work.
    """

    def __init__(self, root: Union[str, pathlib.Path],
                 version: int = TRACE_VM_VERSION):
        self.root = pathlib.Path(root).expanduser()
        self.version = int(version)
        self._check_format_marker()
        for layer in ("layer1", "layer2"):
            (self.root / layer).mkdir(parents=True, exist_ok=True)
        # counters are shared by thread-pool sweeps and asserted on exactly
        # by tests, so increments go through a lock
        self._stats_lock = threading.Lock()
        self._usage_cache: Optional[Dict[str, int]] = None  # lint: guarded-by(_stats_lock)
        self.l1_hits = 0            # lint: guarded-by(_stats_lock)
        self.l1_misses = 0          # lint: guarded-by(_stats_lock)
        self.l2_hits = 0            # lint: guarded-by(_stats_lock)
        self.l2_misses = 0          # lint: guarded-by(_stats_lock)
        self.writes = 0             # lint: guarded-by(_stats_lock)
        self.corrupt_drops = 0      # lint: guarded-by(_stats_lock)

    def _check_format_marker(self) -> None:
        """Refuse directories written by a newer STORE_FORMAT; (re)stamp
        the marker otherwise.  An unreadable marker counts as absent —
        the per-artifact format stamps still protect every load."""
        marker = self.root / "FORMAT.json"
        written: Optional[int] = None
        try:
            written = int(json.loads(marker.read_text())["store_format"])
        except (OSError, ValueError, KeyError, TypeError):
            written = None
        if written is not None and written > STORE_FORMAT:
            raise StoreFormatError(
                f"cache directory {self.root} was written by STORE_FORMAT="
                f"{written}, but this build reads STORE_FORMAT="
                f"{STORE_FORMAT}. Upgrade this build, or point the store "
                f"at a fresh directory (reusing it here would overwrite "
                f"the newer build's artifacts).")
        if written != STORE_FORMAT:
            self.root.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"store_format": STORE_FORMAT}, f)
            os.replace(tmp, marker)

    def _bump(self, counter: str, by: int = 1) -> None:
        with self._stats_lock:
            setattr(self, counter, getattr(self, counter) + by)
            if counter in ("writes", "corrupt_drops"):
                self._usage_cache = None        # disk contents changed

    def invalidate_usage_cache(self) -> None:
        """Force the next ``disk_usage()`` to re-walk (callers that know
        another process just wrote — e.g. after a process-pool sweep)."""
        with self._stats_lock:
            self._usage_cache = None

    def _drop(self, path: pathlib.Path) -> None:
        """Remove an artifact that failed verification/rehydration."""
        self._bump("corrupt_drops")
        try:
            path.unlink()
        except OSError:
            pass

    # -------------------------------------------------------------- keys
    def _key(self, spec: dict) -> str:
        doc = json.dumps(spec, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()[:32]

    def layer1_key(self, workload: str,
                   cache_levels: Sequence[CacheConfig]) -> str:
        return self._key({
            "layer": 1,
            "backend": NAMESPACE,           # namespaced: packages share a dir
            "workload": workload,
            "fingerprint": workload_fingerprint(workload),
            "cache": _cache_geometry(cache_levels),
            "trace_vm": self.version,
        })

    def layer2_key(self, workload: str, cache_levels: Sequence[CacheConfig],
                   cfg: OffloadConfig) -> str:
        return self._key({
            "layer": 2,
            "backend": NAMESPACE,
            "workload": workload,
            "fingerprint": workload_fingerprint(workload),
            "cache": _cache_geometry(cache_levels),
            "trace_vm": self.version,
            "analysis": ANALYSIS_VERSION,   # selection/reshape semantics
            "offload": _offload_spec(cfg),
        })

    def _path(self, layer: int, key: str, suffix: str = "pkl"
              ) -> pathlib.Path:
        # filenames lead with the namespace so disk usage is attributable
        # by name (`stats()["store_bytes_cimtorch"]`)
        return self.root / f"layer{layer}" / f"{NAMESPACE}-{key}.{suffix}"

    # ------------------------------------------------- generic backend blobs
    # Backends persist their own artifacts through these: the caller owns
    # the key spec (and must mix in its backend name + version stamps --
    # see repro_torch.dse.backends), the store owns addressing, atomic
    # writes, verification, and the hit/miss/write counters.  The spec's
    # "backend" field keeps specs of different backends apart; the file
    # name leads with the namespace, as every artifact's does.
    def load_blob(self, layer: int, spec: dict) -> Optional[dict]:
        key = self._key({"layer": layer, **spec})
        path = self._path(layer, key)
        # span dur covers read + zlib inflate + pickle (see _read)
        with obs.span("store.load_blob", cat="store", layer=layer,
                      backend=str(spec.get("backend", "blob"))) as sp:
            payload = self._read(path, key)
            if payload is None:
                self._bump("l1_misses" if layer == 1 else "l2_misses")
                sp.set(hit=False)
                return None
            self._bump("l1_hits" if layer == 1 else "l2_hits")
            sp.set(hit=True, bytes=_fsize(path))
            return payload

    def save_blob(self, layer: int, spec: dict, payload: dict) -> None:
        key = self._key({"layer": layer, **spec})
        path = self._path(layer, key)
        # span dur covers pickle + zlib deflate + atomic publish
        with obs.span("store.save_blob", cat="store", layer=layer,
                      backend=str(spec.get("backend", "blob"))) as sp:
            self._write(path, key, payload)
            sp.set(bytes=_fsize(path))

    # ---------------------------------------------------------------- io
    def _read(self, path: pathlib.Path, expect_key: str) -> Optional[dict]:
        """Load + verify one artifact; anything wrong is a recoverable miss."""
        try:
            with open(path, "rb") as f:
                doc = pickle.loads(zlib.decompress(f.read()))
        except FileNotFoundError:
            return None
        except Exception:
            doc = None
        if (not isinstance(doc, dict) or doc.get("format") != STORE_FORMAT
                or doc.get("key") != expect_key
                or not isinstance(doc.get("payload"), dict)):
            self._drop(path)
            return None
        return doc["payload"]

    def _write(self, path: pathlib.Path, key: str, payload: dict) -> None:
        _publish(path, zlib.compress(pickle.dumps(
            {"format": STORE_FORMAT, "key": key, "payload": payload},
            protocol=pickle.HIGHEST_PROTOCOL)))
        self._bump("writes")

    # ------------------------------------------------------------ layer 1
    # Layer-1 artifacts are compressed .npz column archives, not pickles.
    # The trace and its flow tables live in two sibling files under one
    # key: the trace archive is written once when first built, and the
    # flow file appears later when an analysis first needs it — upgrading a
    # key never re-serializes the trace, and a concurrent trace-only save
    # can never downgrade an artifact that already has flow tables.
    def _flow_path(self, key: str) -> pathlib.Path:
        # the flow tables additionally depend on the IDG/flow construction
        # semantics, which the trace half of the key does not cover
        return (self.root / "layer1"
                / f"{NAMESPACE}-{key}.flow-v{ANALYSIS_VERSION}.npz")

    def _write_npz(self, path: pathlib.Path, key: str,
                   arrays: Dict[str, np.ndarray]) -> None:
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            meta_store_key=np.frombuffer(key.encode(), dtype=np.uint8),
            meta_npz_format=np.asarray([NPZ_FORMAT], np.int64),
            **arrays)
        _publish(path, buf.getvalue())
        self._bump("writes")

    def _read_npz(self, path: pathlib.Path,
                  expect_key: str) -> Optional[Dict[str, np.ndarray]]:
        """Load + verify one .npz artifact; anything wrong is a miss."""
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            key = bytes(arrays["meta_store_key"]).decode()
            fmt = int(arrays["meta_npz_format"][0])
            if key != expect_key or fmt != NPZ_FORMAT:
                raise ValueError("stale or foreign artifact")
            return arrays
        except FileNotFoundError:
            return None
        except Exception:
            self._drop(path)
            return None

    def load_layer1(self, workload: str, cache_levels: Sequence[CacheConfig],
                    device="cuda"
                    ) -> Optional[Tuple[TraceResult, Optional[FlowIndex]]]:
        """The persisted trace (and flow tables, when saved) of one
        (workload, geometry), on ``device``; ``None`` on a miss."""
        dev = resolve_device(device)
        key = self.layer1_key(workload, cache_levels)
        trace_path = self._path(1, key, suffix="npz")
        # span dur covers read + zlib inflate + columnar rehydration
        with obs.span("store.load_l1", cat="store", layer=1,
                      workload=workload) as sp:
            arrays = self._read_npz(trace_path, key)
            if arrays is None:
                self._bump("l1_misses")
                sp.set(hit=False)
                return None
            try:
                ct = ColumnarTrace.from_arrays(arrays, device=dev)
                hier = CacheHierarchy(tuple(cache_levels))
                hier.restore_counters(dict(zip(
                    [str(s) for s in arrays["meta_cc_names"]],
                    arrays["meta_cc_vals"].tolist())))
                outputs = [torch.from_numpy(arrays[f"out_{i}"])
                           for i in range(int(arrays["meta_n_outputs"][0]))]
            except Exception:
                # drop the archive, not just the load: save_layer1 skips
                # keys whose file exists, so a bad-but-readable artifact
                # must leave the filesystem or it would never be repaired
                self._drop(trace_path)
                self._bump("l1_misses")
                sp.set(hit=False, corrupt=True)
                return None
            tr = TraceResult(ct, hier, outputs,
                             structural=StructuralTrace(ct, outputs))
            flow_arrays = self._read_npz(self._flow_path(key), key)
            flow = None
            if flow_arrays is not None:
                try:
                    flow = FlowIndex.from_arrays(flow_arrays, device=dev)
                except Exception:
                    self._drop(self._flow_path(key))
            self._bump("l1_hits")
            sp.set(hit=True,
                   bytes=_fsize(trace_path) + _fsize(self._flow_path(key)))
            return tr, flow

    def save_layer1(self, workload: str, cache_levels: Sequence[CacheConfig],
                    trace_result: TraceResult,
                    flow: Optional[FlowIndex] = None) -> None:
        key = self.layer1_key(workload, cache_levels)
        trace_path = self._path(1, key, suffix="npz")
        # span dur covers columnar flatten + zlib deflate + atomic publish
        with obs.span("store.save_l1", cat="store", layer=1,
                      workload=workload) as sp:
            if not trace_path.exists():  # traces are deterministic per key
                arrays = trace_result.trace.to_arrays()
                counters = trace_result.cache.counters()
                arrays["meta_cc_names"] = np.asarray(list(counters),
                                                     dtype="U")
                arrays["meta_cc_vals"] = np.asarray(list(counters.values()),
                                                    np.int64)
                arrays["meta_n_outputs"] = np.asarray(
                    [len(trace_result.outputs)], np.int64)
                for i, out in enumerate(trace_result.outputs):
                    arrays[f"out_{i}"] = out.cpu().numpy()
                self._write_npz(trace_path, key, arrays)
            if flow is not None and not self._flow_path(key).exists():
                self._write_npz(self._flow_path(key), key, flow.to_arrays())
            sp.set(bytes=_fsize(trace_path) + _fsize(self._flow_path(key)))

    # ------------------------------------------------------------ layer 2
    def load_layer2(self, workload: str, cache_levels: Sequence[CacheConfig],
                    cfg: OffloadConfig, device="cuda"
                    ) -> Optional[Tuple[OffloadResult, ReshapedTrace]]:
        """The persisted selection and reshaped trace, their tensors on
        ``device``; ``None`` on a miss."""
        dev = resolve_device(device)
        key = self.layer2_key(workload, cache_levels, cfg)
        path = self._path(2, key)
        # span dur covers read + zlib inflate + pickle (see _read)
        with obs.span("store.load_l2", cat="store", layer=2,
                      workload=workload) as sp:
            payload = self._read(path, key)
            if payload is None:
                self._bump("l2_misses")
                sp.set(hit=False)
                return None
            offload, reshaped = payload["offload"], payload["reshaped"]
            offload.flow = offload.flow.to(dev)
            reshaped.host_seqs = reshaped.host_seqs.to(dev)
            self._bump("l2_hits")
            sp.set(hit=True, bytes=_fsize(path))
            return offload, reshaped

    def save_layer2(self, workload: str, cache_levels: Sequence[CacheConfig],
                    cfg: OffloadConfig, offload: OffloadResult,
                    reshaped: ReshapedTrace) -> None:
        key = self.layer2_key(workload, cache_levels, cfg)
        path = self._path(2, key)
        # span dur covers pickle + zlib deflate + atomic publish
        with obs.span("store.save_l2", cat="store", layer=2,
                      workload=workload) as sp:
            self._write(path, key,
                        {"offload": offload, "reshaped": reshaped})
            sp.set(bytes=_fsize(path))

    # -------------------------------------------------------------- misc
    def disk_usage(self) -> Dict[str, int]:
        """On-disk bytes, per layer and per owning namespace (filenames
        lead with it, so attribution is a directory walk).

        The walk result is cached and invalidated by this handle's own
        writes/drops, so the repeated ``stats()`` reads on the sweep hot
        path stay O(1); another process's concurrent writes surface on
        this handle's next write or a fresh ``AnalysisStore``."""
        with self._stats_lock:
            cached = self._usage_cache
        if cached is not None:
            return dict(cached)
        out = {"store_bytes_total": 0, "store_bytes_layer1": 0,
               "store_bytes_layer2": 0}
        for layer in ("layer1", "layer2"):
            d = self.root / layer
            if not d.is_dir():
                continue
            for f in d.iterdir():
                try:
                    sz = f.stat().st_size
                except OSError:
                    continue
                out["store_bytes_total"] += sz
                out[f"store_bytes_{layer}"] += sz
                # namespace prefix before the first dash; files without a
                # plausible one land under "unknown"
                backend = f.name.split("-", 1)[0]
                if not ("-" in f.name and backend.isalpha()
                        and len(backend) <= 16):
                    backend = "unknown"
                bkey = f"store_bytes_{backend}"
                out[bkey] = out.get(bkey, 0) + sz
        # publish under the lock: a concurrent _bump() invalidation must
        # not lose against this (possibly stale) walk result being cached
        with self._stats_lock:
            self._usage_cache = dict(out)
        return out

    def stats(self) -> Dict[str, int]:
        return {"store_l1_hits": self.l1_hits,
                "store_l1_misses": self.l1_misses,
                "store_l2_hits": self.l2_hits,
                "store_l2_misses": self.l2_misses,
                "store_writes": self.writes,
                "store_corrupt_drops": self.corrupt_drops,
                **self.disk_usage()}

    def __repr__(self) -> str:
        return (f"AnalysisStore({str(self.root)!r}, version={self.version}, "
                f"l1={self.l1_hits}h/{self.l1_misses}m, "
                f"l2={self.l2_hits}h/{self.l2_misses}m)")
