"""PyTorch/CUDA port of the HAP package ``repro``.

The module names follow ``repro`` one for one, so each module's JAX
counterpart sits at the same path under ``src/repro/``. The port imports
``torch`` and numpy only, never ``jax`` or ``repro``. Entry point:

    from repro_torch.solver import solve
    res = solve(points)                  # runs on "cuda"
    res = solve(points, device="cpu")    # plain PyTorch path on the CPU

On a CUDA tensor the heavy per-sweep updates run through the hand-written
kernels in ``repro_torch/csrc``; on a CPU tensor they run through the
kernels' plain PyTorch versions.
"""
