"""The port's copies of the dataset tools of ``scripts/`` that import the
JAX package, each run as ``python -m rtvc_tpu_torch.scripts.<name>``.
``stm`` is the STM parser ``tedlium_transcript`` imports."""
