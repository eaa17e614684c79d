"""The benchmark of ``repro_torch``, the PyTorch/CUDA port: one cell (a
model configuration under a traffic mix) run once by ``bench/run.py``.

Everything a cell needs is found by name: ``configs/<config>.json`` (the
published configuration as run), ``cells/<workload>.json`` (slots, cache
length, offered rate, the scheduler and the correctness limit),
``traffic/<traffic>.json`` (lengths and arrivals), ``metrics/<name>.py``
(one reader a per-layer metric), and for each ``model_type`` a mapping to
the port's configuration (``port/<model_type>.py``) and a plain fp32
reference (``reference/<model_type>.py``).  Nothing here imports JAX or
the JAX package, and the reference imports nothing of the port.
"""
