"""Launchers (PyTorch port): the LM training driver (``launch/train.py``),
the serving driver (``launch/serve.py``), the
experiment sweep (``launch/sweep.py``), population training
(``launch/pop.py``), the instrumented rollout (``launch/profile.py``) and
the run-history trends (``launch/history.py``); each runs as ``python -m
repro_torch.launch.<name>``."""
