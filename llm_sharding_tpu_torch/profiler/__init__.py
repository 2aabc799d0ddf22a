"""The capability profiler (``profiler.py``) and its ``profile.json``
(``artifacts.py``): the port of ``llm_sharding_tpu/profiler/``."""

from . import profiler  # noqa: F401
from .profiler import Profiler, fit_latency_models, max_layers_fit  # noqa: F401
