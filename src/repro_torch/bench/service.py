"""BENCH: DSE-service load generation — "heavy traffic" with a number.

Twin of ``benchmarks/bench_service.py``, on an explicit device: the same
storm, probe, warm repeat, gates and JSON schema, plus the device the
daemon ran on and each kernel's launches during the storm.  N concurrent
clients sweep *overlapping* design spaces against one daemon, so the same
canonical ``SweepPoint.key``s arrive from many requests at once; the
daemon's coalescing stack (record memo + single-flight + warm analysis
cache) must collapse them to one evaluation per unique key.  The
benchmark measures and asserts exactly that:

* **requests/sec, p50/p99 latency** over the whole storm,
* **dedup ratio** — points requested / points evaluated (> 1.5× with the
  default overlapping spaces),
* **evaluations == unique keys** — the daemon never computed a design
  twice,
* **warm repeat** — an exhaustive sweep re-issued against the warm
  daemon performs zero new trace builds and zero new evaluations.

On ``cuda`` (the default) the in-process daemon's replays launch the
replay kernel and its selections the placement kernel; the JSON says how
many of each, and whether the storm compiled the kernels (a checkout
without built kernels waits for ``nvcc`` at its first launch) or loaded
them (the first launch in a process).  The JSON goes to
``--json`` (default ``build/bench_torch/bench_service.json``, never the
reference's ``BENCH_service.json``).  ``--url`` points the storm at an
externally started ``python -m repro_torch.dse.service`` instead::

    python -m repro_torch.bench service                       # cuda
    python -m repro_torch.bench service --device cpu --clients 4
    python -m repro_torch.bench service --url http://127.0.0.1:8321 \\
        --workloads NB
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.bench.common import DEFAULT_OUT, banner
from repro_torch.dse import SweepSpace
from repro_torch.dse.service import ServiceClient, running_server

CACHES = ("32K+256K", "64K+256K", "64K+2M")
LEVELS = ("L1_only", "L2_only", "both")
TECHS = ("sram", "fefet")

# reserved for the coalesce probe: never part of the main storm, so its
# analysis keys are guaranteed cold when the probe fires
PROBE_WORKLOAD = "DT"

DEFAULT_JSON = DEFAULT_OUT / "bench_service.json"


def client_space(client_id: int, workloads: Sequence[str]) -> Dict:
    """The request document for one client: a rotated, truncated slice of
    the full axis grid — every client overlaps its neighbors on most keys
    but no two slices are identical."""
    def rotate(axis: Sequence[str], k: int) -> List[str]:
        k = k % len(axis)
        return list(axis[k:] + axis[:k])

    caches = rotate(CACHES, client_id)[: 2 + client_id % 2]
    levels = rotate(LEVELS, client_id // 2)[: 2 + (client_id + 1) % 2]
    return {"workloads": list(workloads), "caches": caches,
            "cim_levels": levels, "techs": list(TECHS), "mode": "sweep"}


def unique_keys(requests: Sequence[Dict]) -> int:
    """How many distinct canonical designs the storm asks for in total —
    computed client-side from the same SweepSpace enumeration the daemon
    uses, so `evaluated == unique` is an exact cross-check."""
    keys = set()
    for doc in requests:
        space = SweepSpace(workloads=tuple(doc["workloads"]),
                           caches=tuple(doc["caches"]),
                           cim_levels=tuple(doc["cim_levels"]),
                           techs=tuple(doc["techs"]))
        keys.update(p.key for p in space.points())
    return len(keys)


def _launches(metrics: Dict) -> Dict[str, int]:
    return dict(metrics["accel"]["launches"])


def _builds(metrics: Dict, service) -> Dict[str, Optional[int]]:
    """The CiM cache's build counters; ``single_replays`` (one replay
    launch each, outside ``replay_batches``) only from an in-process
    daemon, since ``/metrics`` carries the reference's keys alone."""
    cim = metrics["cache"]["cim"]
    return {"trace_builds": cim["layer1"]["builds"],
            "offload_builds": cim["layer2"]["builds"],
            "replay_batches": cim["replay_batches"],
            "single_replays": (None if service is None else
                               service.analysis_cache("cim").single_replays)}


def run(url: Optional[str] = None, clients: int = 8,
        requests_per_client: int = 2,
        workloads: Sequence[str] = ("NB", "LCS"),
        cache_dir: Optional[str] = None,
        json_path: Optional[str] = None, device="cuda",
        service=None) -> Dict:
    """One storm, probe and warm repeat.  ``url`` targets a running
    daemon; ``service`` is that daemon's :class:`DSEService` when it runs
    in this process (its cache counts the single-geometry replays, and
    its kernels share this process's build)."""
    from repro_torch.core.accel import _build

    ctx = (contextlib.nullcontext((url, service)) if url
           else running_server(cache_dir=cache_dir, max_workers=4,
                               device=device))
    with ctx as (base_url, service):
        client = ServiceClient(base_url)
        client.wait_ready()
        m0 = client.metrics()
        b0 = _builds(m0, service)
        compiled_before, loaded_before = (len(_build.build_logs),
                                          len(_build._libs))

        # ---- the storm: clients * requests, overlapping spaces ---------
        docs = [client_space(i % clients, workloads)
                for i in range(clients * requests_per_client)]
        latencies: List[float] = []
        trace_ids: List[Optional[str]] = []
        errors: List[str] = []
        lock = threading.Lock()
        barrier = threading.Barrier(clients)

        def one_client(cid: int) -> None:
            local = ServiceClient(base_url)
            barrier.wait()                   # all clients fire together
            for rid in range(requests_per_client):
                doc = docs[cid * requests_per_client + rid]
                t0 = time.perf_counter()
                try:
                    reply = local.sweep(doc["workloads"],
                                        caches=doc["caches"],
                                        cim_levels=doc["cim_levels"],
                                        techs=doc["techs"])
                except Exception as exc:  # noqa: BLE001 — reported below
                    with lock:
                        errors.append(f"client {cid} req {rid}: {exc}")
                    return
                with lock:
                    latencies.append(time.perf_counter() - t0)
                    trace_ids.append(reply.trace_id)

        threads = [threading.Thread(target=one_client, args=(i,))
                   for i in range(clients)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        storm_s = time.perf_counter() - t_start
        if errors:
            raise RuntimeError("bench clients failed: " + "; ".join(errors))

        # ---- per-request traces: distinct ids, last one queryable ------
        if any(tid is None for tid in trace_ids):
            tracing = {"enabled": False}
        else:
            try:
                tree = client.trace(trace_ids[-1])
                last_spans: Optional[int] = tree["n_spans"]
            except Exception as exc:  # noqa: BLE001 — gated in check()
                last_spans = None
                print(f"  trace lookup failed: {exc}")
            tracing = {"enabled": True,
                       "n_requests": len(trace_ids),
                       "distinct_ids": len(set(trace_ids)),
                       "last_trace_spans": last_spans,
                       "trace_ids": trace_ids}

        m1 = client.metrics()
        pts0 = m0["service"].get("points", {})
        pts1 = m1["service"]["points"]
        requested = pts1["requested"] - pts0.get("requested", 0)
        evaluated = pts1["evaluated"] - pts0.get("evaluated", 0)
        coalesced = pts1["coalesced"] - pts0.get("coalesced", 0)
        memo_hits = pts1["memo_hits"] - pts0.get("memo_hits", 0)
        unique = unique_keys(docs)
        l0, l1 = _launches(m0), _launches(m1)
        storm_launches = {k: l1[k] - l0[k] for k in l1}
        b1 = _builds(m1, service)
        storm_builds = {k: None if v is None else v - b0[k]
                        for k, v in b1.items()}
        # an in-process daemon shares this process's kernel libraries
        kernels_during = (None if service is None else {
            "compiled": len(_build.build_logs) > compiled_before,
            "loaded": len(_build._libs) > loaded_before})

        # ---- coalesce probe: guaranteed-overlap identical requests -----
        # A perfectly serialized storm could in principle satisfy every
        # duplicate from the memo; fire identical requests at a cold
        # workload simultaneously so the single-flight path itself is
        # exercised.
        probed = False
        if coalesced == 0:
            probed = True
            probe_barrier = threading.Barrier(4)

            def probe() -> None:
                local = ServiceClient(base_url)
                probe_barrier.wait()
                local.sweep([PROBE_WORKLOAD], caches=list(CACHES))

            probe_threads = [threading.Thread(target=probe)
                             for _ in range(4)]
            for t in probe_threads:
                t.start()
            for t in probe_threads:
                t.join()
            m1 = client.metrics()
            pts1 = m1["service"]["points"]
            coalesced = pts1["coalesced"] - pts0.get("coalesced", 0)

        # ---- warm repeat: zero new trace builds, zero evaluations ------
        warm_doc = client_space(0, workloads)
        builds_before = m1["cache"]["cim"]["layer1"]["builds"]
        eval_before = m1["service"]["points"]["evaluated"]
        launches_before = _launches(m1)
        reply = client.sweep(warm_doc["workloads"], caches=warm_doc["caches"],
                             cim_levels=warm_doc["cim_levels"],
                             techs=warm_doc["techs"])
        m2 = client.metrics()
        warm_trace_builds = (m2["cache"]["cim"]["layer1"]["builds"]
                             - builds_before)
        warm_evaluated = m2["service"]["points"]["evaluated"] - eval_before
        warm_launches = {k: v - launches_before[k]
                         for k, v in _launches(m2).items()}

        ordered = sorted(latencies)

        def pick(q: float) -> float:
            return ordered[min(len(ordered) - 1,
                               max(0, round(q * (len(ordered) - 1))))]

        doc = {
            "clients": clients,
            "requests_per_client": requests_per_client,
            "workloads": list(workloads),
            "device": m0["accel"]["device"],
            "n_requests": len(latencies),
            "storm_wall_s": storm_s,
            "requests_per_s": len(latencies) / storm_s,
            "latency_s": {
                "p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99),
                "mean": statistics.fmean(latencies), "max": ordered[-1]},
            "points": {"requested": requested, "evaluated": evaluated,
                       "unique_keys": unique, "coalesced": coalesced,
                       "memo_hits": memo_hits},
            "dedup_ratio": round(requested / evaluated, 3) if evaluated
                           else None,
            "coalesce_probe": probed,
            "storm_launches": storm_launches,
            "storm_builds": storm_builds,
            "kernels_during_storm": kernels_during,
            "warm_repeat": {"n_records": len(reply.records),
                            "trace_builds": warm_trace_builds,
                            "evaluated": warm_evaluated,
                            "launches": warm_launches},
            "tracing": tracing,
        }
    if json_path:
        path = pathlib.Path(json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=1))
    return doc


def check(doc: Dict) -> List[str]:
    """The bench's own gates (the reference's, plus the launch count)."""
    failures = []
    pts = doc["points"]
    if pts["evaluated"] != pts["unique_keys"]:
        failures.append(f"evaluated {pts['evaluated']} != unique keys "
                        f"{pts['unique_keys']} — a design was computed twice")
    if doc["dedup_ratio"] is None or doc["dedup_ratio"] <= 1.5:
        failures.append(f"dedup ratio {doc['dedup_ratio']} <= 1.5x — "
                        f"overlapping requests were not coalesced")
    if pts["coalesced"] < 1:
        failures.append("zero coalesced evaluations — the single-flight "
                        "path never fired")
    warm = doc["warm_repeat"]
    if warm["trace_builds"] != 0 or warm["evaluated"] != 0:
        failures.append(f"warm repeat did work: {warm['trace_builds']} "
                        f"trace builds, {warm['evaluated']} evaluations")
    if doc["device"].startswith("cuda"):
        # on the card every replay batch, single-geometry replay and
        # selection build is one launch; an external daemon's metrics
        # carry no single replays, so its replays are only bounded
        sl, sb = doc["storm_launches"], doc["storm_builds"]
        replay_ok = (sl["replay"] == sb["replay_batches"]
                     + sb["single_replays"]
                     if sb["single_replays"] is not None else
                     sb["replay_batches"] <= sl["replay"]
                     <= sb["trace_builds"])
        if (not replay_ok or sl["replay"] <= 0
                or sl["place"] != sb["offload_builds"]
                or sl["place"] <= 0):
            failures.append(f"storm launches {sl} do not match its builds "
                            f"{sb}")
        if any(warm["launches"].values()):
            failures.append(f"warm repeat launched kernels: "
                            f"{warm['launches']}")
    tr = doc.get("tracing") or {}
    if tr.get("enabled"):          # a --no-trace daemon is record-only here
        if tr["distinct_ids"] != tr["n_requests"]:
            failures.append(f"{tr['n_requests']} storm requests produced "
                            f"only {tr['distinct_ids']} distinct trace ids "
                            f"— per-request root spans are not isolated")
        if not tr.get("last_trace_spans"):
            failures.append("the last storm trace id did not resolve via "
                            "/v1/trace/<id> — ring buffer evicted or the "
                            "trace was never finished")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench service",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--url", default=None,
                    help="target an externally started daemon instead of "
                         "an in-process server")
    ap.add_argument("--device", default="cuda",
                    help="where the in-process daemon runs: cuda (default) "
                         "or cpu")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests-per-client", type=int, default=2)
    ap.add_argument("--workloads", default="NB,LCS",
                    help="comma-separated Table-IV programs for the storm "
                         f"(keep {PROBE_WORKLOAD} out: it is the reserved "
                         "coalesce-probe workload)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent store for the in-process daemon")
    ap.add_argument("--json", default=str(DEFAULT_JSON))
    ap.add_argument("--no-check", action="store_true",
                    help="record only; skip the dedup/coalesce gates")
    args = ap.parse_args(argv)

    banner("BENCH: DSE service under concurrent load")
    workloads = tuple(args.workloads.split(","))
    doc = run(url=args.url, clients=args.clients,
              requests_per_client=args.requests_per_client,
              workloads=workloads, cache_dir=args.cache_dir,
              json_path=args.json, device=args.device)
    lat = doc["latency_s"]
    pts = doc["points"]
    print(f"  device {doc['device']}: {doc['n_requests']} requests from "
          f"{doc['clients']} clients in {doc['storm_wall_s']:.3f}s "
          f"({doc['requests_per_s']:.2f} req/s)")
    print(f"  latency p50 {lat['p50']:.4f}s  p90 {lat['p90']:.4f}s  "
          f"p99 {lat['p99']:.4f}s  max {lat['max']:.4f}s")
    print(f"  points: {pts['requested']} requested -> {pts['evaluated']} "
          f"evaluated ({pts['unique_keys']} unique keys; "
          f"{pts['coalesced']} coalesced, {pts['memo_hits']} memo hits) "
          f"— dedup x{doc['dedup_ratio']}")
    print(f"  storm launches {json.dumps(doc['storm_launches'])}, builds "
          f"{json.dumps(doc['storm_builds'])}; kernels compiled / loaded "
          f"during the storm: {json.dumps(doc['kernels_during_storm'])}")
    warm = doc["warm_repeat"]
    print(f"  warm repeat: {warm['n_records']} records, "
          f"{warm['trace_builds']} trace builds, "
          f"{warm['evaluated']} evaluations, launches "
          f"{json.dumps(warm['launches'])}")
    tr = doc["tracing"]
    if tr.get("enabled"):
        print(f"  traces: {tr['distinct_ids']} distinct ids over "
              f"{tr['n_requests']} requests; last tree "
              f"{tr['last_trace_spans']} spans via /v1/trace")
    else:
        print("  traces: daemon tracing disabled (record-only)")
    if args.json:
        print(f"  [json] {args.json}")
    if not args.no_check:
        failures = check(doc)
        for f in failures:
            print(f"  FAIL: {f}")
        if failures:
            return 1
        print("  gates: dedup > 1.5x, evaluated == unique, coalesced >= 1, "
              "warm repeat free — all passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
