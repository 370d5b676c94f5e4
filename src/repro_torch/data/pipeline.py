"""QUIP as a training-data pipeline stage (the port of
``repro/data/pipeline.py``).

At cluster scale the training corpus is materialized by relational queries
over feature/event tables that contain missing values; ``QuipCleanStage``
runs those queries through the QUIP executor (lazy/adaptive imputation) and
tokenizes the result into fixed-shape global batches for the LM trainer.
The queries run through the port's ``execute_quip`` on ``device`` (their
bloom probes launch the bloom-probe kernel on a card); the tokens are host
numpy, bit for bit the reference's on the same tables, queries and seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.executor import ExecutionResult, execute_quip
from repro_torch.core.plan import Query
from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import ImputationEngine
from repro_torch.imputers.mean import MeanImputer

__all__ = ["QuipCleanStage", "rows_to_tokens"]


def rows_to_tokens(rel: MaskedRelation, vocab: int, seq_len: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Serialize answer rows into token sequences (value-bucket encoding):
    each cell becomes a token ``hash(col, bucket(value)) % vocab``; rows are
    concatenated and chunked to seq_len.  ``rng`` is accepted as in the
    reference and draws nothing."""
    cols = rel.column_names()
    n = rel.num_rows
    stream = np.zeros((n, len(cols)), dtype=np.int64)
    for ci, name in enumerate(cols):
        v = rel.values(name).astype(np.float64)
        v = np.nan_to_num(v)
        bucket = np.floor(v).astype(np.int64)
        stream[:, ci] = (bucket * 1315423911 + ci * 2654435761) % max(vocab - 2, 1) + 1
    flat = stream.reshape(-1)
    n_seq = max(len(flat) // seq_len, 1)
    if len(flat) < n_seq * seq_len:
        flat = np.pad(flat, (0, n_seq * seq_len - len(flat)))
    return flat[: n_seq * seq_len].reshape(n_seq, seq_len)


@dataclasses.dataclass
class QuipCleanStage:
    """Materializes QUIP query answers into LM token batches."""

    tables: Dict[str, MaskedRelation]
    queries: List[Query]
    vocab: int
    seq_len: int
    global_batch: int
    strategy: str = "adaptive"
    engine_factory: Optional[Callable[[], ImputationEngine]] = None
    seed: int = 0
    device: str = "cuda"

    def _engine(self) -> ImputationEngine:
        if self.engine_factory is not None:
            return self.engine_factory()
        return ImputationEngine(
            {t: r.copy() for t, r in self.tables.items()},
            default=MeanImputer,
        )

    def run_queries(self) -> List[ExecutionResult]:
        out = []
        for q in self.queries:
            eng = self._engine()
            out.append(execute_quip(q, self.tables, eng,
                                    strategy=self.strategy,
                                    device=self.device))
        return out

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of {'tokens','labels'} global batches built from
        the (lazily cleaned) query answers."""
        rng = np.random.default_rng(self.seed)
        seqs: List[np.ndarray] = []
        for res in self.run_queries():
            if res.relation.num_rows:
                seqs.append(
                    rows_to_tokens(res.relation, self.vocab, self.seq_len + 1, rng)
                )
        if not seqs:
            raise ValueError("QUIP pipeline produced no rows")
        pool = np.concatenate(seqs, axis=0)
        while True:
            idx = rng.integers(0, len(pool), self.global_batch)
            chunk = pool[idx]
            yield {
                "tokens": chunk[:, :-1].astype(np.int32),
                "labels": chunk[:, 1:].astype(np.int32),
            }
