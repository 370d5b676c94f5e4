"""QuipService in miniature with the PyTorch port: a skewed multi-tenant
stream served by a worker pool with plan caching and cross-query
imputation sharing, vs cold-engine serial replay, with the bloom probes and
the KNN imputer's distances on ``--device``.

    PYTHONPATH=src python examples/quip_serve_demo_torch.py               # the card
    PYTHONPATH=src python examples/quip_serve_demo_torch.py --device cpu
"""
import argparse

from repro_torch.core.executor import execute_quip
from repro_torch.data.queries import serving_workload
from repro_torch.data.synthetic import wifi_dataset
from repro_torch.imputers import ImputationEngine, KnnImputer
from repro_torch.service import QuipService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    tables, _ = wifi_dataset(n_users=150, n_wifi=2000, n_occ=1000)
    stream = list(serving_workload("wifi", tables, n_queries=12,
                                   n_templates=4, n_tenants=3, seed=2))
    factory = lambda: KnnImputer(k=5, cost_per_value=2e-3,  # noqa: E731
                                 device=args.device)

    # cold-engine serial replay: what every query costs without the service
    serial = {}
    serial_imps = serial_batches = 0
    for _tenant, q in stream:
        eng = ImputationEngine(
            {t: r.copy() for t, r in tables.items()}, default=factory
        )
        res = execute_quip(q, tables, eng, strategy="adaptive",
                           device=args.device)
        serial[id(q)] = sorted(res.answer_tuples())
        serial_imps += res.counters.imputations
        serial_batches += res.counters.impute_batches

    svc = QuipService(tables, factory, max_inflight=4, shared_impute=True,
                      workers=args.workers, device=args.device)
    tickets = [svc.submit(q, tenant=tenant) for tenant, q in stream]
    svc.run_until_idle()

    print(f"{'ticket':>6} {'tenant':>6} {'plan':>5} {'wait ms':>8} "
          f"{'latency ms':>10} {'imputed':>8} {'cross-hits':>10} "
          f"{'== serial':>9}")
    for ticket, (_, q) in zip(tickets, stream):
        rec = next(r for r in svc.serving.records if r.ticket == ticket)
        same = sorted(svc.answers(ticket)) == serial[id(q)]
        print(f"{rec.ticket:>6} {rec.tenant:>6} "
              f"{'hit' if rec.plan_cache_hit else 'miss':>5} "
              f"{rec.queue_wait_s * 1e3:>8.2f} {rec.latency_s * 1e3:>10.2f} "
              f"{rec.counters.imputations:>8} "
              f"{rec.counters.impute_cross_hits:>10} {str(same):>9}")

    s = svc.summary()
    svc.close()
    print(f"\n{args.device}, {args.workers} workers")
    print(f"plan cache: {s['plan_cache_hits']} hits / "
          f"{s['plan_cache_misses']} misses (size {s['plan_cache_size']})")
    print(f"latency: p50 {s['p50_latency_s'] * 1e3:.1f} ms, "
          f"p95 {s['p95_latency_s'] * 1e3:.1f} ms; "
          f"peak concurrency {s['max_concurrent']}")
    print(f"imputer invocations: {s['impute_batches']} "
          f"(serial replay paid {serial_batches}); "
          f"values computed: {s['imputations']} vs {serial_imps} serial — "
          f"{serial_imps - s['imputations']} served from the shared store")


if __name__ == "__main__":
    main()
