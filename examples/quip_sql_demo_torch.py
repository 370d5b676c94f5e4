"""QUIP with the PyTorch port on the synthetic UCI-WiFi workload: each
strategy's imputation count and runtime with an expensive (KNN) imputer
-- the paper's Experiment 1 in miniature.  The bloom probes and the KNN
imputer's distances run on ``--device``.

    PYTHONPATH=src python examples/quip_sql_demo_torch.py               # the card
    PYTHONPATH=src python examples/quip_sql_demo_torch.py --device cpu
"""
import argparse

from repro_torch.core.executor import execute_offline, execute_quip
from repro_torch.data.queries import workload
from repro_torch.data.synthetic import wifi_dataset
from repro_torch.imputers import ImputationEngine, KnnImputer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tables, _ = wifi_dataset(n_users=200, n_wifi=4000, n_occ=2000)
    queries = workload("wifi", tables, kind="low", n_queries=4, seed=1)
    factory = lambda: KnnImputer(k=5, cost_per_value=2e-3,  # noqa: E731
                                 device=args.device)
    for strategy in ("offline", "imputedb", "lazy", "adaptive"):
        imps = wall = 0
        for q in queries:
            eng = ImputationEngine(
                {t: r.copy() for t, r in tables.items()}, default=factory
            )
            if strategy == "offline":
                res = execute_offline(q, tables, eng, device=args.device)
            else:
                res = execute_quip(q, tables, eng, strategy=strategy,
                                   device=args.device)
            imps += res.counters.imputations
            wall += res.counters.wall_seconds
        print(f"{strategy:>9}: imputations={imps:6d} "
              f"runtime={wall * 1e3:8.1f} ms")


if __name__ == "__main__":
    main()
