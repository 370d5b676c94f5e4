"""Bloom-filter probe: wrappers of the CUDA kernels ``csrc/bloom_probe.cu``.

Replaces the reference package's Pallas kernel ``bloom_probe_pallas``
(``repro/kernels/bloom_probe.py``).  ``bloom_probe`` takes keys folded to
uint32 on the host, as the reference's does; ``bloom_probe_keys`` takes the
raw int64 keys and folds them in the kernel, which is what the port's
``BloomFilter`` calls.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor takes the plain torch version (``ref.bloom_probe_ref``,
``ref.bloom_probe_keys_ref``), since the kernels exist only on the card.
"""

from __future__ import annotations


import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import count as _count
from repro_torch.kernels.hashing import MAX_HASHES

__all__ = ["bloom_probe", "bloom_probe_keys", "keys_launches", "launches"]

#: kernel launches since the counters were last set to 0: the folded-key
#: entry's and the int64-key entry's
launches = 0
keys_launches = 0


def _check(bits: torch.Tensor, keys: torch.Tensor, name: str,
           dtype: torch.dtype, num_hashes: int, log2m: int) -> None:
    if not 5 <= log2m <= 31:
        raise ValueError(f"log2m must lie in [5, 31], got {log2m}")
    if not 1 <= num_hashes <= MAX_HASHES:
        raise ValueError(f"num_hashes must lie in [1, {MAX_HASHES}], "
                         f"got {num_hashes}")
    if bits.dtype != torch.int32 or bits.dim() != 1:
        raise ValueError(f"bits must be a 1-D int32 tensor holding uint32 "
                         f"bits, got {bits.dtype} {tuple(bits.shape)}")
    if keys.dtype != dtype or keys.dim() != 1:
        raise ValueError(f"{name} must be a 1-D {dtype} tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    for what, t in (("bits", bits), (name, keys)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if bits.shape[0] != (1 << log2m) // 32:
        raise ValueError(f"bits has {bits.shape[0]} words, expected "
                         f"{(1 << log2m) // 32} for log2m={log2m}")
    if bits.device != keys.device:
        raise ValueError(f"bits on {bits.device}, {name} on {keys.device}")
    if keys.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the bloom probe runs on cuda or cpu, not "
                         f"{keys.device}")


def _launch(entry: str, bits: torch.Tensor, keys: torch.Tensor,
            out: torch.Tensor, num_hashes: int, log2m: int) -> None:
    from repro_torch.kernels import build

    lib = build.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(bits.data_ptr(), keys.data_ptr(),
                                 out.data_ptr(), keys.shape[0], num_hashes,
                                 log2m, stream)
    build.check(rc, entry)


def bloom_probe(bits: torch.Tensor, folded: torch.Tensor, *,
                num_hashes: int, log2m: int) -> torch.Tensor:
    """bits: ``(2**log2m // 32,)`` int32 (uint32 words); folded: ``(n,)``
    int32 (uint32 host-folded keys) → ``(n,)`` bool, True iff every one of
    the ``num_hashes`` multiply-shift bits is set."""
    _check(bits, folded, "folded", torch.int32, num_hashes, log2m)
    if folded.device.type == "cpu":
        return _ref.bloom_probe_ref(bits, folded, num_hashes, log2m)
    out = torch.empty(folded.shape, dtype=torch.bool, device=folded.device)
    if folded.shape[0] == 0:
        return out
    _launch("quipt_bloom_probe", bits, folded, out, num_hashes, log2m)
    _count(globals(), "launches")
    return out


def bloom_probe_keys(bits: torch.Tensor, keys: torch.Tensor, *,
                     num_hashes: int, log2m: int) -> torch.Tensor:
    """``bloom_probe`` of ``(n,)`` int64 keys, each folded to uint32 in the
    kernel (``hashing.fold64``'s bits).  ``keys`` may be a view that does
    not start on a 16-byte boundary (``keys[1:]``)."""
    _check(bits, keys, "keys", torch.int64, num_hashes, log2m)
    if keys.device.type == "cpu":
        return _ref.bloom_probe_keys_ref(bits, keys, num_hashes, log2m)
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    if keys.shape[0] == 0:
        return out
    _launch("quipt_bloom_probe_keys", bits, keys, out, num_hashes, log2m)
    _count(globals(), "keys_launches")
    return out
