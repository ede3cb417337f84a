"""PyTorch + CUDA port of the FGOP reproduction for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or ``jax``.  Layout mirrors ``repro``:

  kernels/    registry (KernelSpec / Variant / Coalescer), oracles, the
              CUDA kernel loader, the primitive kernels' wrappers and
              the ``ops`` API over them
  csrc/       the hand-written Hopper kernels (K1-K21), built at first
              use
  pipelines/  fused solver chains, the DAG stages and the unfused
              baselines: kernel wrappers + plain versions
  serve/      SolverMux serving stack (scheduler, served DAGs, cost
              model, faults)
  launch/     entry points (``python -m repro_torch.launch.serve_solvers``,
              ``python -m repro_torch.launch.dsp_pipeline``)
  core/       FGOP stream descriptors, masks, region dependences,
              criticality

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions; with no GPU and no explicit CPU
device they raise.
"""
