"""Hash join of int64 keys: wrapper of the CUDA kernels ``csrc/hash_join.cu``.

Replaces the reference package's Pallas pair ``hash_join_build_pallas`` /
``hash_join_probe_pallas`` (``repro/kernels/hash_join.py``).  The kernels
hash the full int64 key into a table of distinct keys, group the build rows
by key in ascending row order, and emit every ``(probe_idx, build_idx)``
pair with equal keys, probe-major, build rows ascending within a probe —
the order of ``core.triggers.multi_match``, exactly, with no 64-bit check
left for the host.  The grouping partitions the rows by owner (a range of
``OWNER_SLOTS`` slots) with the segment kernels
(``segment_ops.group_rows``), then one block per owner places its own
rows; ``ref.hash_join_group_ref`` emulates the steps on the CPU.  The
probe finds and scans the match counts in one kernel, waits once for the
total (an 8-byte copy into pinned memory and an event synchronise), and
emits the pairs along the merge path of the probes' ends and the pairs,
``EMIT_TILE`` items a block; ``ref.hash_join_emit_tiles_ref`` emulates the
emit.

A CUDA tensor launches the kernels on the current stream; a CPU tensor
takes the plain torch sort-join (``ref.hash_join_build_ref`` /
``ref.hash_join_probe_ref``), since the kernels exist only on the card.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import count as _count

__all__ = ["JoinTable", "OWNER_SLOTS", "build_launches", "hash_join",
           "hash_join_build", "hash_join_probe", "probe_launches",
           "table_log2cap"]

#: build (insert + place) launches since the counter was last set to 0
build_launches = 0
#: probe (probe-and-scan + emit) launches since the counter was last set to 0
probe_launches = 0

MIN_LOG2CAP = 7  # 128 slots
MAX_BUILD_ROWS = 1 << 30  # a slot index and a row id must fit int32
#: slots a place block owns, its cursors in shared memory (the kernel's
#: ``kOwnerSlots``)
OWNER_SLOTS = 8064
#: merged items (probe ends and pairs) an emit block covers (the kernel's
#: ``kEmitTile``, which ``quipt_join_emit_tile`` returns), for the CPU
#: emulation
EMIT_TILE = 1024

# the pinned host word each thread reads a probe's total into
_pinned = threading.local()


class JoinTable(NamedTuple):
    """A built table on the card: ``slot_row`` holds 1 + the first row of
    each slot's key (0 = empty), ``slot_count`` the key's rows,
    ``slot_start`` where they begin in ``grouped``, which lists the build
    rows grouped by key, ascending within a key."""

    keys: torch.Tensor  # (n,) int64 build keys
    log2cap: int
    slot_row: torch.Tensor  # (cap,) int32
    slot_count: torch.Tensor  # (cap,) int32
    slot_start: torch.Tensor  # (cap,) int64
    grouped: torch.Tensor  # (n,) int32


def table_log2cap(n_build: int) -> int:
    """log2 of the slot count: at least twice the build rows (the distinct
    keys, at most the rows, then fill at most half the table), and 128."""
    return max(MIN_LOG2CAP, (2 * max(n_build, 1) - 1).bit_length())


def _check_keys(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int64 tensor, got "
                         f"{getattr(t, 'dtype', type(t))} "
                         f"{tuple(getattr(t, 'shape', ()))}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"hash join runs on cuda or cpu, not {t.device}")


def hash_join_build(build_keys: torch.Tensor
                    ) -> Union[JoinTable, Tuple[torch.Tensor, torch.Tensor]]:
    """Build the table of ``build_keys`` ``(n,)`` int64.  On the CPU the
    plain version's ``(sorted_keys, order)`` stands in for the table."""
    _check_keys("build_keys", build_keys)
    if build_keys.device.type == "cpu":
        return _ref.hash_join_build_ref(build_keys)
    n = build_keys.shape[0]
    if n >= MAX_BUILD_ROWS:
        raise ValueError(f"{n} build rows exceed the kernel's "
                         f"{MAX_BUILD_ROWS}")
    from repro_torch.kernels import build, segment_ops

    dev = build_keys.device
    log2cap = table_log2cap(n)
    cap = 1 << log2cap
    slot_row = torch.zeros(cap, dtype=torch.int32, device=dev)
    slot_count = torch.zeros(cap, dtype=torch.int32, device=dev)
    grouped = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return JoinTable(build_keys, log2cap, slot_row, slot_count,
                         slot_count.to(torch.int64), grouped)
    row_slot = torch.empty(n, dtype=torch.int32, device=dev)
    row_owner = torch.empty(n, dtype=torch.int64, device=dev)
    owners = -(-cap // OWNER_SLOTS)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quipt_join_insert(build_keys.data_ptr(), n, log2cap,
                                   slot_row.data_ptr(), slot_count.data_ptr(),
                                   row_slot.data_ptr(), row_owner.data_ptr(),
                                   stream)
        build.check(rc, "hash_join_build (insert)")
        owner_count, owner_start, perm = segment_ops.group_rows(
            lib, row_owner, owners, stream)
        slot_start = torch.cumsum(slot_count, 0, dtype=torch.int64) - slot_count
        rc = lib.quipt_join_place(perm.data_ptr(), owner_start.data_ptr(),
                                  owner_count.data_ptr(), owners,
                                  row_slot.data_ptr(), slot_start.data_ptr(),
                                  grouped.data_ptr(), cap, stream)
        build.check(rc, "hash_join_build (place)")
    _count(globals(), "build_launches")
    return JoinTable(build_keys, log2cap, slot_row, slot_count, slot_start,
                     grouped)


def _read_total(word: torch.Tensor, stream) -> int:
    """The call's one host wait: ``word`` (one int64 on the card) copied
    into this thread's pinned buffer on ``stream``, then an event
    synchronise."""
    key = word.device.index
    held = getattr(_pinned, "by_device", None)
    if held is None:
        held = _pinned.by_device = {}
    if key not in held:
        host = torch.empty(1, dtype=torch.int64, pin_memory=True)
        held[key] = (host, host.numpy(), torch.cuda.Event())
    host, view, done = held[key]
    host.copy_(word, non_blocking=True)
    done.record(stream)
    done.synchronize()
    return int(view[0])


def hash_join_probe(table, probe_keys: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every ``(probe_idx, build_idx)`` pair of ``probe_keys`` ``(m,)``
    int64 against a built table, as int64 tensors on the keys' device."""
    _check_keys("probe_keys", probe_keys)
    if not isinstance(table, JoinTable):
        if probe_keys.device.type != "cpu":
            raise ValueError("a table built on the CPU probes CPU keys only")
        return _ref.hash_join_probe_ref(*table, probe_keys)
    if table.keys.device != probe_keys.device:
        raise ValueError(f"table on {table.keys.device}, probe keys on "
                         f"{probe_keys.device}")
    from repro_torch.kernels import build

    dev = probe_keys.device
    m = probe_keys.shape[0]
    if m == 0 or table.keys.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z.clone()
    lib = build.library()
    # one int64 buffer whose layout the kernels' entry points own: the
    # total in word 0, then the look-back's scratch, each probe's end and
    # its key's start in `grouped`
    n_words = lib.quipt_join_probe_words(m)
    words = torch.empty(n_words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        rc = lib.quipt_join_probe(table.keys.data_ptr(),
                                  table.keys.shape[0],
                                  table.slot_row.data_ptr(),
                                  table.slot_start.data_ptr(),
                                  probe_keys.data_ptr(), m, table.log2cap,
                                  words.data_ptr(), n_words,
                                  stream.cuda_stream)
        build.check(rc, "hash_join_probe (probe)")
        # everything the emit needs but the total, ready before the wait:
        # the window between the wait and the emit's launch is the host's
        emit = lib.quipt_join_emit
        args = (words.data_ptr(), m, table.grouped.data_ptr())
        total = _read_total(words[:1], stream)
        out_probe = torch.empty(total, dtype=torch.int64, device=dev)
        out_build = torch.empty(total, dtype=torch.int64, device=dev)
        rc = emit(*args, total, out_probe.data_ptr(), out_build.data_ptr(),
                  stream.cuda_stream)
        build.check(rc, "hash_join_probe (emit)")
    _count(globals(), "probe_launches")
    return out_probe, out_build


def hash_join(build_keys: torch.Tensor, probe_keys: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``(probe_idx, build_idx)`` pairs with equal int64 keys, ordered
    by probe and, within a probe, by ascending build row."""
    _check_keys("build_keys", build_keys)
    _check_keys("probe_keys", probe_keys)
    if build_keys.device != probe_keys.device:
        raise ValueError(f"build keys on {build_keys.device}, probe keys on "
                         f"{probe_keys.device}")
    return hash_join_probe(hash_join_build(build_keys), probe_keys)
