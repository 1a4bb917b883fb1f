"""The port's user scripts, run as ``python -m enhancing_tpu_torch.scripts.<name>``:
``reconstruct``, ``sample``, ``evaluate`` and ``eval_samples``,
counterparts of the JAX package's ``scripts/*.py`` of those names. Each
reads ``configs/<config>.yaml`` relative to the working directory, runs on
``--device`` (default ``cuda``), and exposes ``main(argv)``."""
