"""QUIP (query-driven missing value imputation) in PyTorch and CUDA.

The port of the reference package ``repro`` to an NVIDIA H100, one slice at
a time.  It mirrors ``repro``'s module paths and imports nothing of it:
the relational engine stays host numpy, and the device work runs through
hand-written CUDA kernels (``csrc/``) bound in :mod:`repro_torch.kernels`.
Entry points take an explicit ``device``; the default ``"cuda"`` raises
where there is no card, and only ``device="cpu"`` runs on the CPU.
"""
