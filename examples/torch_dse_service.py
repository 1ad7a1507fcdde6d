"""Serve + query the port's DSE daemon (`repro_torch.dse.service`).

Twin of ``examples/dse_service.py``.  The engine as a resident service:
one warm analysis cache answers many clients' sweep/adaptive queries over
HTTP/JSON, coalescing duplicate work.  This example runs the whole loop
in one process — start an in-process daemon on the card (or the CPU),
query it like a remote client would, and read the coalescing evidence
and the kernels' launches off ``/metrics``::

    PYTHONPATH=src python examples/torch_dse_service.py             # cuda
    PYTHONPATH=src python examples/torch_dse_service.py --device cpu
    PYTHONPATH=src python examples/torch_dse_service.py \\
        --cache-dir /tmp/eva-store-torch

Against a real daemon the client half is identical — start one with::

    PYTHONPATH=src python -m repro_torch.dse.service --port 8321

and point :class:`repro_torch.dse.service.ServiceClient` at
``http://127.0.0.1:8321``.
"""
import argparse
import sys
import threading

from repro_torch.dse.service import ServiceClient, running_server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="NB",
                    help="a Table-IV program (default NB, the smallest)")
    ap.add_argument("--device", default="cuda",
                    help="where the daemon runs: cuda (default) or cpu")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent AnalysisStore dir shared with the CLI")
    args = ap.parse_args(argv)

    with running_server(cache_dir=args.cache_dir,
                        device=args.device) as (url, _service):
        client = ServiceClient(url)
        print(f"== daemon up at {url}: {client.healthz()['status']} ==")

        # -- exhaustive sweep --------------------------------------------
        reply = client.sweep([args.workload],
                             caches=["32K+256K", "64K+256K", "64K+2M"],
                             cim_levels=["L1_only", "L2_only", "both"],
                             techs=["sram", "fefet"])
        print(f"== sweep: {len(reply.records)} records, "
              f"{reply.stats.get('trace_builds')} trace builds ==")
        for rec in reply.frontier:
            print(f"   frontier {rec['cache']}/cim@{rec['cim_levels']}"
                  f"/{rec['tech']}: E {rec['energy_improvement']:.2f}x "
                  f"spd {rec['speedup']:.2f}x")

        # -- adaptive, streamed round by round ---------------------------
        print("== adaptive (rounds stream as they complete) ==")
        for event in client.adaptive_events(
                [args.workload],
                caches=["32K+256K", "64K+256K", "64K+2M"],
                cim_levels=["L1_only", "L2_only", "both"],
                techs=["sram", "fefet"]):
            if event["event"] == "round":
                print(f"   round {event['round']}: {event['n_priced']} new "
                      f"points, frontier {event['frontier_size']}"
                      + (" [stable]" if event["stable"] else ""))
            elif event["event"] == "result":
                print(f"   result: {event['n_records']} points priced total")

        # -- two overlapping clients: the daemon computes each key once --
        spaces = (["sram", "fefet"], ["fefet"])        # overlapping techs
        threads = [threading.Thread(
            target=lambda t=t: client.sweep([args.workload], techs=t))
            for t in spaces]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        metrics = client.metrics()
        pts = metrics["service"]["points"]
        print(f"== metrics: {pts['requested']} points requested, "
              f"{pts['evaluated']} evaluated "
              f"({pts['coalesced']} coalesced in flight, "
              f"{pts['memo_hits']} memo hits) — "
              f"dedup {metrics['dedup_ratio']}x ==")
        acc = metrics["accel"]
        print(f"   device {acc['device']}: replay kernel "
              f"{acc['launches']['replay']} launches, placement kernel "
              f"{acc['launches']['place']} (0 on the CPU: plain versions)")
        if args.cache_dir:
            store = metrics.get("store", {})
            print(f"   store: {store.get('store_l1_hits', 0)} l1 hits / "
                  f"{store.get('store_writes', 0)} writes / "
                  f"{store.get('store_corrupt_drops', 0)} corrupt drops "
                  f"under {args.cache_dir}")
    print("== daemon shut down cleanly ==")
    return 0


if __name__ == "__main__":
    sys.exit(main())
