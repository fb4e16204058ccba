"""PyTorch / CUDA port of SpecInF (``repro`` is the reference): the serving
engine, the single-device trainer, the runtime that fills the trainer's
bubbles with the engine's work under Algorithm 1, and the failure
containment and crash durability around them (``resilience``,
``checkpoint``).

The package mirrors ``repro``'s layout module by module and imports neither
JAX nor anything of ``repro``: what it needs from a host-only module there
(configs, the page pool, the metrics registry, the control plane) it keeps
as its own copy.
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CUDA tensor every attention core launches a hand-written Hopper kernel
(``repro_torch/kernels/csrc``), on a CPU tensor its plain PyTorch version.
"""
