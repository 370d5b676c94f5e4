"""Bloom-filter probe: wrapper of the CUDA kernel ``csrc/bloom_probe.cu``.

Replaces the reference package's Pallas kernel ``bloom_probe_pallas``
(``repro/kernels/bloom_probe.py``).  A CUDA tensor launches the kernel on
the current stream; a CPU tensor takes the plain torch version
(``ref.bloom_probe_ref``), since the kernel exists only on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.hashing import MAX_HASHES

__all__ = ["bloom_probe", "launches"]

#: kernel launches since the counter was last set to 0
launches = 0


def _check(bits: torch.Tensor, folded: torch.Tensor, num_hashes: int,
           log2m: int) -> None:
    if not 5 <= log2m <= 31:
        raise ValueError(f"log2m must lie in [5, 31], got {log2m}")
    if not 1 <= num_hashes <= MAX_HASHES:
        raise ValueError(f"num_hashes must lie in [1, {MAX_HASHES}], "
                         f"got {num_hashes}")
    for name, t in (("bits", bits), ("folded", folded)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor holding "
                             f"uint32 bits, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bits.shape[0] != (1 << log2m) // 32:
        raise ValueError(f"bits has {bits.shape[0]} words, expected "
                         f"{(1 << log2m) // 32} for log2m={log2m}")
    if bits.device != folded.device:
        raise ValueError(f"bits on {bits.device}, folded on {folded.device}")


def bloom_probe(bits: torch.Tensor, folded: torch.Tensor, *,
                num_hashes: int, log2m: int) -> torch.Tensor:
    """bits: ``(2**log2m // 32,)`` int32 (uint32 words); folded: ``(n,)``
    int32 (uint32 host-folded keys) → ``(n,)`` bool, True iff every one of
    the ``num_hashes`` multiply-shift bits is set."""
    global launches
    _check(bits, folded, num_hashes, log2m)
    if folded.device.type == "cpu":
        return _ref.bloom_probe_ref(bits, folded, num_hashes, log2m)
    if folded.device.type != "cuda":
        raise ValueError(f"bloom_probe runs on cuda or cpu, not "
                         f"{folded.device}")
    from repro_torch.kernels import build

    out = torch.empty(folded.shape, dtype=torch.bool, device=folded.device)
    n = folded.shape[0]
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(folded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quipt_bloom_probe(bits.data_ptr(), folded.data_ptr(),
                                   out.data_ptr(), n, num_hashes, log2m,
                                   stream)
    build.check(rc, "bloom_probe")
    launches += 1
    return out
