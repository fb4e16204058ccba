"""PyTorch / CUDA port of the SpecInF serving path (``repro`` is the reference).

The package mirrors ``repro``'s layout module by module and imports neither
JAX nor anything of ``repro``: what it needs from a host-only module there
(configs, the page pool, the metrics registry) it keeps as its own copy.
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CUDA tensor every attention core launches a hand-written Hopper kernel
(``repro_torch/kernels/csrc``), on a CPU tensor its plain PyTorch version.
"""
