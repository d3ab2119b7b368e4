"""The measuring layer (counterpart of the JAX package's root ``bench.py``
and ``tools/``): each module runs as ``python -m mipnerf360_torch.tools.<name>``,
on the card unless ``--device cpu`` is given, and names the card (and its
power limit) beside every rate it prints.

- ``bench``: training rays/s per card (parity compute, quality compute,
  quality staging) and the MFU of the matmuls; ``--mode render`` the
  render rays/s.
- ``profile_step``: the train step split into timed pieces.
- ``ab_step``: the step with one piece stubbed out, timed again.
- ``sample_axis_bench``: render rays/s against samples per ray.
- ``parity_psnr``: the quality record, PSNR at equal iterations against
  the recorded reference run and convergence at the flagship operating
  point (its sections name the card but hold no rate).
"""
