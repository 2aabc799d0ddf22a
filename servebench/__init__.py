"""The served benchmark of ``llm_sharding_tpu_torch`` on one H100: see
``README.md``. Importing the package loads neither torch nor the port."""
