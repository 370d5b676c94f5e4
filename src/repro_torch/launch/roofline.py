"""Roofline analysis of a step on the NVIDIA H100 (the port of
``repro/launch/roofline.py``).

    compute term    = FLOPs per device / 989e12 bf16 FLOP/s
    memory term     = bytes accessed per device / 3.35e12 B/s of HBM
    collective term = collective bytes per device / the link's B/s

The reference reads XLA's ``cost_analysis()`` and the compiled HLO text.
PyTorch compiles nothing ahead of time, so here the counts come from the
ops a rank runs: :class:`CostCounter` is a dispatch mode that sees each
local op (under DTensor, the op on the rank's own shard) and counts

* FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention; elementwise ops count none);
* bytes accessed as eager PyTorch moves them: each op's inputs read once
  and its outputs written once, views and collectives moving none.  XLA
  counts after fusion, so its figure for the same step is smaller;
* collective bytes by kind, each collective's output at the local shape,
  as the reference sums the output shapes of the partitioned HLO;
* memory: the bytes of the tensors alive on the rank over the step, each
  storage rounded up to the caching allocator's 512-byte block.

DTensor's own work beside the step is not the rank's: it infers an op's
output shape by running it at the global shape on fake tensors, which the
counter leaves out, and computes shard offsets and redistribution plans on
small CPU tensors, which a counter given the step's device (``meta`` in a
dry run) leaves out too.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HW", "CostCounter", "RooflineReport", "collective_kind",
           "link_bw", "local_tensors", "model_flops", "render_report"]

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit: 989 TFLOP/s in bf16 on the tensor cores.
PEAK_FLOPS = 989e12
# The same data sheet: 80 GB of HBM3 at 3.35 TB/s.
HBM_BW = 3.35e12
# NVLink 4 inside one host of 8 cards: 900 GB/s a card, 450 GB/s each way
# (the data sheet and the Hopper architecture white paper).
NVLINK_BW = 450e9
# Between hosts: one 400 Gb/s NIC a card (ConnectX-7 in NVIDIA's DGX H100
# reference design), 50 GB/s each way.
NIC_BW = 50e9
#: cards joined by NVLink in one host
CARDS_PER_HOST = 8

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
      "nic_bw": NIC_BW, "cards_per_host": CARDS_PER_HOST}

#: the caching allocator's block: every allocation is rounded up to it
ALLOC_BLOCK = 512


def link_bw(mesh_shape) -> float:
    """The collective rate of a mesh: NVLink when every axis's group fits
    in one host, else the NIC (the production meshes' groups of 16 span
    two hosts or more)."""
    return NVLINK_BW if max(mesh_shape, default=1) <= CARDS_PER_HOST \
        else NIC_BW


# --------------------------------------------------------------------------- #
# the counter
# --------------------------------------------------------------------------- #
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")
#: op-name fragments → the reference's kind names (first match wins)
_KINDS = (("reduce_scatter", "reduce-scatter"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce", "all-reduce"))
#: point-to-point and rooted moves, counted with the reference's
#: collective-permute
_PERMUTES = ("send", "recv", "p2p", "broadcast", "scatter", "gather")
#: ops that move no data: waits, barriers, metadata
_FREE_OPS = ("wait_tensor", "barrier", "monitored_barrier", "check_for_nan",
             "_wrap_tensor_autograd")
_ALLOC_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")
#: in-place writes of a few entries: they read their sources and indices
#: and write as many entries, not the whole destination
_SCATTERS = ("scatter_", "scatter_add_", "scatter_reduce_", "index_put_",
             "index_copy_", "index_add_", "masked_scatter_")


def collective_kind(func) -> Optional[str]:
    """The reference's kind name of a collective op (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``); ``None`` for any other op, and for the waits."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    if name in _FREE_OPS:
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    if any(frag in name for frag in _PERMUTES):
        return "collective-permute"
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a wrapper with no storage
        return None


class CostCounter(TorchDispatchMode):
    """Counts the ops this rank runs while the mode is active (see the
    module's docstring): ``flops``, ``bytes_accessed``, ``collectives``
    (bytes by kind), and over the tensors allocated in the window,
    ``live_bytes`` and ``peak_bytes`` (rounded to :data:`ALLOC_BLOCK`).

    ``hold(tree)`` takes the tensors of ``tree`` (a DTensor's local shard)
    as live from the start and returns their bytes, so that the peak is
    that of the whole device: the step's arguments.  A DTensor op is left
    to DTensor, whose local ops the mode then sees.  With ``device`` (a
    device type), only ops that touch a tensor on it are counted."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = device
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._tracked: Dict[int, int] = {}  # storage key -> bytes

    # -- memory ---------------------------------------------------------- #
    def _track(self, t: torch.Tensor) -> None:
        st = _storage(t)
        if st is None:
            return
        key = st._cdata
        with self._lock:
            if key in self._tracked:
                return
            n = _block(st.nbytes())
            self._tracked[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._tracked.pop(key, 0)

    def hold(self, tree: Any) -> int:
        """Take the tensors of ``tree`` as live; returns the bytes of the
        storages not held before."""
        before = self.live_bytes
        for t in local_tensors(tree):
            self._track(t)
        return self.live_bytes - before

    def storage_keys(self, tree: Any) -> set:
        return {st._cdata for st in map(_storage, local_tensors(tree))
                if st is not None}

    def bytes_of(self, keys) -> int:
        with self._lock:
            return sum(self._tracked.get(k, 0) for k in keys)

    # -- the ops ------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._on_device(args, kwargs, out):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _on_device(self, *trees) -> bool:
        """Whether the op is the step's: no fake tensor in it (DTensor's
        shape inference runs on fake tensors) and, with ``device``, one
        tensor on that device (DTensor's bookkeeping, shard offsets and
        redistribution plans, computes on small CPU tensors beside a step
        whose shards are on ``meta``)."""
        from torch._subclasses.fake_tensor import FakeTensor

        tensors = [t for t in tree_leaves(trees)
                   if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in tensors):
            return False
        return self.device is None or any(t.device.type == self.device
                                          for t in tensors)

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = collective_kind(func)
        with self._lock:
            self.ops += 1
            if kind is not None:
                self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                    _nbytes(t) for t in outs)
            elif not (func.is_view or func.namespace == "prim"
                      or func._opname in _FREE_OPS
                      or func._opname in _ALLOC_ONLY):
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                if func._opname in _SCATTERS:
                    src = ins[1:]
                    self.bytes_accessed += sum(_nbytes(t) for t in src) \
                        + _nbytes(src[-1])
                else:
                    self.bytes_accessed += sum(_nbytes(t) for t in ins) \
                        + sum(_nbytes(t) for t in outs)
            formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            with self._lock:
                self.flops += flops
        if func._opname not in _FREE_OPS:  # a wait returns its input
            for t in outs:
                self._track(t)

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": sum(self.collectives.values()),
                "collectives": dict(self.collectives),
                "peak_bytes": self.peak_bytes, "ops": self.ops}


def local_tensors(tree: Any) -> list:
    """The tensors of ``tree`` (a module's parameters and buffers
    included), each DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    out = []
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(
            x, torch.nn.Module)):
        if isinstance(leaf, torch.nn.Module):
            out += [*leaf.parameters(), *leaf.buffers()]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return [t.to_local() if isinstance(t, DTensor) else t for t in out]


# --------------------------------------------------------------------------- #
# the report
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RooflineReport:
    """One cell's three terms against the H100's constants.  The field
    names are the reference's: ``hlo_flops`` and ``hlo_bytes`` hold the
    counter's FLOPs and bytes accessed per device (there is no HLO here);
    ``link_bw`` is the collective rate of the cell's mesh
    (:func:`link_bw`)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    collective_bytes: float  # per device
    per_kind: Dict[str, int]
    model_flops: float  # analytic 6·N·D (whole step, global)
    bytes_per_device: Optional[float] = None  # peak memory
    link_bw: float = NIC_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def t_bound(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the roofline bound the *useful* math achieves:
        (model_flops / chips / peak) / max(term)."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        bound = self.t_bound
        return ideal / bound if bound else 0.0

    def row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
            f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
            f"{self.useful_ratio:.2f} | {self.roofline_fraction:.2%} |"
        )


def render_report(path: str, mesh_filter: Optional[str] = None) -> str:
    """Markdown §Roofline table from a dryrun --out JSON."""
    import json

    with open(path) as f:
        rows = json.load(f)
    out = [
        "| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
        "bottleneck | useful | roofline | peak mem (GB) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    skips = []
    for r in rows:
        if "skipped" in r:
            skips.append(f"| {r['arch']} | {r['shape']} | — skipped: "
                         f"{r['skipped']} |")
            continue
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        rf = r.get("roofline", {})
        peak = r.get("memory", {}).get("peak_bytes")
        # sub-ms decode cells: depth-extrapolation noise can go negative
        clamp = lambda v: max(0.0, v)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{clamp(rf.get('t_compute_ms', 0)):.1f} | "
            f"{clamp(rf.get('t_memory_ms', 0)):.1f} | "
            f"{clamp(rf.get('t_collective_ms', 0)):.1f} | "
            f"{rf.get('bottleneck','-')} | "
            f"{clamp(rf.get('useful_ratio', 0)):.2f} | "
            f"{clamp(rf.get('roofline_fraction', 0))*100:.1f}% | "
            f"{(peak or 0)/1e9:.2f} |"
        )
    return "\n".join(out + [""] + sorted(set(skips)))


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6·N_active·D for training, 2·N_active·D
    for inference (D = tokens processed), plus attention O(S²) term."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * tokens
        attn_mult = 3.0  # fwd + bwd(2x)
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n_active * tokens
        attn_mult = 1.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch * 1
        base = 2.0 * n_active * tokens
        attn_mult = 1.0

    # attention score/context FLOPs
    attn_flops = 0.0
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            continue
        s = shape.seq_len
        if shape.kind == "decode":
            q_len, k_len = 1, s
        else:
            q_len, k_len = s, s
        if kind == "local" and cfg.local_window:
            k_len = min(k_len, cfg.local_window)
        per_seq = 2.0 * 2.0 * cfg.n_heads * hd * q_len * k_len * 0.5
        attn_flops += per_seq * shape.global_batch * attn_mult
    return base + attn_flops


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default="dryrun_report.json")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    print(render_report(args.report, args.mesh))
