"""PyTorch + CUDA port of ``llm_sharding_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one stays the reference: every module here
names its JAX counterpart (``file:line``) and the tests in
``tests/test_torch_*.py`` drive both packages with the same numpy inputs.

This package imports ``torch`` and never ``jax`` or ``llm_sharding_tpu``
(not even that package's stdlib-only modules: importing them runs
``llm_sharding_tpu/models/__init__.py`` / ``runtime/__init__.py``, which
load jax). Importing it starts nothing and builds nothing: the CUDA
kernels under ``csrc/`` are compiled on first use (``ops/kernels.py``).

Entry points (``runtime/engine.Engine``, ``runtime/generate.generate``,
``utils/shard_store.load_full`` / ``load_stage``,
``utils/convert.params_from_hf``, ``models/{llama,gpt2}.init_params``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (``device.resolve_device``).
``python -m llm_sharding_tpu_torch convert`` (``cli.py``) turns an HF
checkpoint into a shard store on the CPU.
"""
